"""Host seconds of the operator layout's build in set-up (the program's
set-up span ``imgp.layout.build``, ``ops.sparse_formats.build_layout``: RCM
ordering, block-ELL tables or DIA bands): the operator layer's share of
``setup_s``."""

from portbench.harness.registry import span_seconds


def read(run):
    return span_seconds("imgp.layout.build", totals=True)
