"""The traced window: ``torch.profiler`` over it, reduced to what the
per-layer readers and the result's ``breakdown`` need.

The profiler records CPU ops (with their shapes and concrete arguments)
and device activity. The reduction keeps, for every device operation
(kernel, memcpy, memset): its name, start and duration, the width of the
operand it was launched for where a port kernel's launch shows it (the
``aten::empty`` of its output, the last one before the launch on the
launching thread: ``[rows, width]``), and whether its launch ran inside one
of a set of CPU ops. Busy time is the union of the device intervals, so
operations that overlap count once.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

# the port's kernels, by the name of their __global__ function
PORT_KERNELS = {
    "fwd": ("block_ell_spmv_kernel",),
    "k3": ("block_ell_bwd_blocks_kernel",),
    "k4": ("dia_window_kernel", "dia_general_kernel", "dia_row_kernel"),
}
# the dense linear algebra of a basis solve (CPU ops whose launches count)
DENSE_LA_OPS = ("aten::linalg_eigh", "aten::linalg_qr", "aten::_linalg_svd", "aten::mm",
                "aten::addmm", "aten::bmm")


def kernel_family(name: str):
    """"fwd", "k3", "k4" for a port kernel's device name, else None."""
    for family, names in PORT_KERNELS.items():
        if any(n in name for n in names):
            return family
    return None


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    width: int = None  # operand width of a port kernel's launch
    dense_la: bool = False  # launched inside one of DENSE_LA_OPS


@dataclasses.dataclass
class TraceSummary:
    ops: list  # [DeviceOp]
    busy_s: float
    window_s: float
    idle_by_host_op: list  # [(host op name, idle seconds)], largest first

    def time_s(self, family: str = None, port: bool = None) -> float:
        """Device seconds of one kernel family, or of the port's kernels
        (``port=True``) or of everything else (``port=False``)."""
        total = 0
        for op in self.ops:
            fam = kernel_family(op.name)
            if family is not None and fam != family:
                continue
            if port is not None and (fam is not None) != port:
                continue
            total += op.dur_ns
        return total * 1e-9

    def top_ops(self, count: int = 10) -> list:
        by_name = collections.Counter()
        for op in self.ops:
            by_name[op.name] += op.dur_ns
        return [[name, ns * 1e-9] for name, ns in by_name.most_common(count)]


class Profiler:
    """``with Profiler(on): ...`` traces the block when ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                record_shapes=True)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self, window_s: float) -> TraceSummary:
        return reduce_events(self.prof.profiler.kineto_results.events(), window_s)


def _union(intervals):
    """Merged [start, end) intervals of a list of (start, end)."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _empty_width(event):
    """The width of a 2-D ``aten::empty`` from its concrete size argument."""
    try:
        size = event.concrete_inputs()[0]
    except (AttributeError, IndexError, RuntimeError):
        return None
    if isinstance(size, (list, tuple)) and len(size) == 2:
        return int(size[1])
    return None


def reduce_events(events, window_s: float) -> TraceSummary:
    """Reduce the profiler's events (``kineto_results.events()``)."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, launches, empties, dense = [], {}, collections.defaultdict(list), \
        collections.defaultdict(list)
    host_ops = collections.defaultdict(list)
    for e in events:
        if e.device_type() == cuda:
            device.append(e)
            continue
        if e.device_type() != cpu:
            continue
        name = e.name()
        tid = e.start_thread_id()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith("cuda") or name.startswith("cu"):
            # a CUDA runtime or driver call: the launch of a device op
            launches[e.correlation_id()] = (tid, start)
        elif name == "aten::empty":
            width = _empty_width(e)
            if width is not None:
                empties[tid].append((start, width))
        if name in DENSE_LA_OPS:
            dense[tid].append((start, end))
        host_ops[tid].append((start, end, name))
    empty_starts = {tid: [s for s, _ in rows] for tid, rows in empties.items()}
    dense_union = {tid: _union(rows) for tid, rows in dense.items()}
    dense_starts = {tid: [s for s, _ in rows] for tid, rows in dense_union.items()}

    ops = []
    for e in device:
        op = DeviceOp(e.name(), e.start_ns(), e.duration_ns())
        launch = launches.get(e.correlation_id())
        if launch is not None:
            tid, t = launch
            if kernel_family(op.name) is not None and tid in empties:
                i = bisect.bisect_right(empty_starts[tid], t) - 1
                if i >= 0:
                    op.width = empties[tid][i][1]
            if tid in dense_union:
                i = bisect.bisect_right(dense_starts[tid], t) - 1
                op.dense_la = i >= 0 and dense_union[tid][i][1] >= t
        ops.append(op)
    busy = _union([(op.start_ns, op.start_ns + op.dur_ns) for op in ops])
    busy_s = sum(end - start for start, end in busy) * 1e-9
    return TraceSummary(ops=ops, busy_s=busy_s, window_s=window_s,
                        idle_by_host_op=_idle_by_host_op(busy, host_ops))


def _idle_by_host_op(busy, host_ops, count: int = 10):
    """Idle seconds between device-busy intervals, by the innermost host op
    that covers each gap's middle on the thread that drove the device (the
    one with the most ops); gaps no op covers count as "host (no op)"."""
    if not busy or not host_ops:
        return []
    tid = max(host_ops, key=lambda t: len(host_ops[t]))
    rows = sorted(host_ops[tid])
    starts = [r[0] for r in rows]
    idle = collections.Counter()
    for (_, prev_end), (next_start, _) in zip(busy, busy[1:]):
        mid = (prev_end + next_start) // 2
        name = "host (no op)"
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting op that still covers the middle is the innermost
        for j in range(i, max(i - 256, -1), -1):
            if rows[j][1] >= mid:
                name = rows[j][2]
                break
        idle[name] += next_start - prev_end
    return [[name, ns * 1e-9] for name, ns in idle.most_common(count)]
