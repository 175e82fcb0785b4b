"""Host seconds of the port's kNN graph build (``ops.graph.build_graph``),
ending in a device synchronize: the graph layer's share of set-up."""


def read(run):
    return run.spans.get("graph_s")
