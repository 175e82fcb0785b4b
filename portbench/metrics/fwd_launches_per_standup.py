"""Forward block-ELL launches per stand-up over the window (the launch
counter's difference): the basis solver's applies."""

from portbench.harness.readers import per_unit


def read(run):
    count = sum(run.counters.get("fwd", {}).values())
    return per_unit(count, run) if count else None
