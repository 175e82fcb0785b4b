"""Host seconds of the kNN graph's host tail in set-up (the program's set-up
span ``imgp.graph.host_tail``, ``ops.graph.symmetrize_knn_edges``: the
edges oriented, coalesced and copied to the device): the part of
``graph_s`` only the program can shorten."""

from portbench.harness.registry import span_seconds


def read(run):
    return span_seconds("imgp.graph.host_tail", totals=True)
