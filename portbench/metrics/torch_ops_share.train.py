"""Device time of the operations that are not the port's own kernels
(PyTorch's elementwise work, reductions, gathers, copies) over the
device's busy time in a training window, in %."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.time_s(port=False) / run.trace.busy_s
