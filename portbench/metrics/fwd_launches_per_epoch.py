"""Forward block-ELL launches per training epoch over the window (the
launch counter's difference): operator applies, which track CG and
Lanczos iterations, the normalization's solves and the preconditioner's
builds."""

from portbench.harness.readers import per_unit


def read(run):
    count = sum(run.counters.get("fwd", {}).values())
    return per_unit(count, run) if count else None
