"""What a per-layer reader (``metrics/<name>.py``) is given, and the
arithmetic several of them share. A reader returns None where it finds
nothing to read; the run then leaves its metric out."""

from __future__ import annotations

import dataclasses
import sys

from . import roofline
from .trace import kernel_family


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    spans: dict  # host seconds of the harness's own spans ("graph_s")
    units: int  # epochs or stand-ups in the window
    counters: dict  # launch counters over the window (program.counters_since)
    layout: dict  # the operator layout's sizes (program.layout_spec)
    device_name: str
    trace: object = None  # trace.TraceSummary of the window, with --trace 1


def _warn(msg: str):
    print(f"portbench: {msg}", file=sys.stderr)


def training_panel_bytes(config: dict) -> int:
    return 2 if config["inference"]["spmv_dtype"] == "bfloat16" else 4


def block_share(run: Run, family: str, panel_bytes: int) -> float:
    """A block-ELL kernel's share of its roofline over the window, in %:
    the bounds of its launches (by width, from the counters) over its device
    time in the trace. ``family`` "fwd" (panels of ``panel_bytes``) or "k3"
    (output of ``panel_bytes``)."""
    peaks = roofline.card_peaks(run.device_name)
    widths = run.counters.get(family, {})
    launches = sum(widths.values())
    if run.trace is None or peaks is None or not launches or run.layout["format"] != "block":
        return None
    traced = sum(1 for op in run.trace.ops if kernel_family(op.name) == family)
    if traced != launches:
        _warn(f"{family}: {traced} launches in the trace, {launches} counted; not read")
        return None
    count = roofline.block_fwd if family == "fwd" else roofline.block_bwd
    bound = sum(c * roofline.bound_s(*count(run.layout, b, panel_bytes), peaks, panel_bytes == 2)
                for b, c in widths.items())
    return 100.0 * bound / run.trace.time_s(family)


def dia_share(run: Run, band_bytes: int) -> float:
    """K4's share of its roofline over the window, in %: each launch's
    bound at the width of its operand (from the trace) over its time."""
    peaks = roofline.card_peaks(run.device_name)
    if run.trace is None or peaks is None or run.layout["format"] != "dia":
        return None
    ops = [op for op in run.trace.ops if kernel_family(op.name) == "k4"]
    if not ops or len(ops) != run.counters.get("k4", 0) or any(op.width is None for op in ops):
        _warn(f"k4: {len(ops)} traced launches, {run.counters.get('k4')} counted, "
              f"{sum(op.width is None for op in ops)} of unknown width; not read")
        return None
    bound = sum(roofline.bound_s(*roofline.dia_fwd(run.layout, op.width, band_bytes), peaks,
                                 band_bytes == 2) for op in ops)
    return 100.0 * bound / (sum(op.dur_ns for op in ops) * 1e-9)


def idle_share(run: Run) -> float:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def per_unit(count: int, run: Run) -> float:
    return None if not run.units else count / run.units
