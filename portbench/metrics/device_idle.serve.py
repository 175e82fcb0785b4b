"""The share of a serving window in which no operation ran on the device,
in %: 1 - the union of the device intervals over the window."""

from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
