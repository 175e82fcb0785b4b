"""Structured metrics, logging and profiling (port of
``manifold_gp_tpu.utils.metrics``).

A per-epoch metrics recorder with a JSONL sink, wall-clock phase timers,
rank-0-only output for multi-process runs, and a ``torch.profiler`` trace
scope that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from typing import Optional

import torch


def is_host_zero() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` group, else True."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricsRecorder:
    """Append-only JSONL metrics sink (rank 0 only); every row is also kept
    in ``history``."""

    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = pathlib.Path(path) if path else None
        self.verbose = verbose
        self.history: list[dict] = []
        if self.path and is_host_zero():
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **metrics}
        self.history.append(row)
        if not is_host_zero():
            return
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        if self.verbose:
            parts = [f"step={step}"] + [
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            ]
            print("[metrics] " + " ".join(parts))


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` scope (CPU, and CUDA when a card is present) that
    writes a Chrome trace, ``trace_<time>.json``, into ``log_dir`` (view it
    in chrome://tracing or Perfetto). Yields the profiler, or None when off."""
    if not enabled or not is_host_zero():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[dict] = None, verbose: bool = False):
    """Wall-clock phase timing, added to ``sink[name]``. Host clock: a phase
    that launches device work should end in a synchronize."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose and is_host_zero():
            print(f"[timer] {name}: {dt:.3f}s")
