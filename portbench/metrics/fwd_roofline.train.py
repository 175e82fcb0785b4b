"""The forward block-ELL kernel's share of its roofline over a training
window, in %: the bounds of its launches at the training panels' type, by
width from the launch counters, over its device time in the trace."""

from portbench.harness.readers import block_share, training_panel_bytes


def read(run):
    return block_share(run, "fwd", training_panel_bytes(run.config))
