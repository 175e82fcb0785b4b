"""The forward block-ELL kernel's share of its roofline over a serving
window, in %: the basis solve's f32 panels, by width from the launch
counters, over its device time in the trace."""

from portbench.harness.readers import block_share


def read(run):
    return block_share(run, "fwd", 4)
