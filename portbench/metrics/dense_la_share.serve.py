"""Device time launched inside the basis's dense algebra (aten eigh, qr,
svd, mm, addmm, bmm) over the device's busy time in a serving window, in
%."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    dense = sum(op.dur_ns for op in run.trace.ops if op.dense_la) * 1e-9
    return 100.0 * dense / run.trace.busy_s
