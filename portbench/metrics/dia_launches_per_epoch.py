"""K4 launches per training epoch over the window (the launch counter's
difference): the DIA path's operator applies."""

from portbench.harness.readers import per_unit


def read(run):
    count = run.counters.get("k4", 0)
    return per_unit(count, run) if count else None
