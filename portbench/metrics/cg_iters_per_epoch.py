"""CG iterations per training epoch over the traced window: the program's
counter ``cg.iterations.<label>`` (``ops.cg``), summed over the labels
(the SLQ gradient's solves and the normalization's one-hot solves), per
epoch."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    iterations = counter("cg.iterations")
    return None if iterations is None else per_unit(iterations, run)
