"""The DIA kernel K4's share of its roofline over a training window, in %:
each launch's bound at its operand's width (read from the trace) over its
device time."""

from portbench.harness.readers import dia_share, training_panel_bytes


def read(run):
    return dia_share(run, training_panel_bytes(run.config))
