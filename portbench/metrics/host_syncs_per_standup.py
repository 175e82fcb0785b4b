"""Host synchronizations per predictor stand-up over the traced window: the
program's counters ``host_sync.<site>`` summed (the basis solve's ``eigh``
and ``svd``, the posterior cache's ``cholesky``), per stand-up."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    syncs = counter("host_sync")
    return None if syncs is None else per_unit(syncs, run)
