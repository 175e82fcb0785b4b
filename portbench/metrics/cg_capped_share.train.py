"""The share of CG solves over the traced training window that stopped at
``cg_max_iter`` with a column still above its tolerance, in %: the
program's counters ``cg.capped`` over ``cg.solves`` (``ops.cg``)."""

from portbench.harness.registry import counter


def read(run):
    solves = counter("cg.solves")
    if not solves:
        return None
    return 100.0 * (counter("cg.capped") or 0) / solves
