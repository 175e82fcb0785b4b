"""Host synchronizations per training epoch over the traced window: the
program's counters ``host_sync.<site>`` summed (its deliberate reads of
device values, and the calls that read their own status: ``eigh``,
``cholesky``), per epoch."""

from portbench.harness.readers import per_unit
from portbench.harness.registry import counter


def read(run):
    syncs = counter("host_sync")
    return None if syncs is None else per_unit(syncs, run)
