"""The share of a traced training window spent in the outputscale
normalization, in %: host seconds of the program's span
``imgp.train.normalize`` (each one-hot CG solve of the average variance;
the span ends in the solve's last stop-test read, so the host waited for
the device) over the window."""

from portbench.harness.registry import span_seconds


def read(run):
    seconds = span_seconds("imgp.train.normalize")
    if seconds is None or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * seconds / run.trace.window_s
