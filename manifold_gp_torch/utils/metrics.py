"""Structured metrics, tracing and profiling (port of
``manifold_gp_tpu.utils.metrics``, with the port's own spans and counters).

A per-epoch metrics recorder with a JSONL sink, rank-0-only output for
multi-process runs, a ``torch.profiler`` trace scope that writes a Chrome
trace, and the program's spans and counters:

``span(name)`` (a context manager) and ``count(name, n)`` mark where the
work happens. Tracing is on while a ``torch.profiler`` records (the
benchmark's traced window, ``profile_trace``); then a span records a range
named ``name`` among the profiler's CPU events, so it shows in the same
trace and on the same clock as the device activity, and spans add their
count and host seconds, counters their count, to the *traced* registry
(``traced()``). The range is PyTorch's fast function record
(``torch._C._profiler._RecordFunctionFast``, pinned by a test), not
``torch.profiler.record_function``: that one is a user annotation, which
the profiler mirrors on the device's timeline as an event spanning every
kernel launched inside it, so a whole epoch would read as device work.
With tracing off a span or counter costs one flag read; a span opened with
``total=True`` (the set-up phases) also costs one host-clock pair, added to
the always-on *totals* registry (``totals()``).

Span names start with ``imgp.``; counter names are dotted
(``cg.iterations.<label>``, ``host_sync.<site>``). A span's host seconds
measure the device only where the span ends in a host read of the device.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import pathlib
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_lock = threading.Lock()  # the autograd thread counts too
_traced_counts: collections.Counter = collections.Counter()
_traced_spans: dict = {}  # name -> [count, host seconds]
_pending: dict = collections.defaultdict(list)  # name -> device tensors not yet read
_totals: dict = {}  # name -> [count, host seconds]
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """True while a ``torch.profiler`` records: torch's private flag
    ``torch.autograd.profiler._is_profiler_enabled`` (pinned by a test)."""
    return _autograd_profiler._is_profiler_enabled


def _add(table: dict, name: str, seconds: float):
    row = table.get(name)
    if row is None:
        table[name] = [1, seconds]
    else:
        row[0] += 1
        row[1] += seconds


class _Span:
    __slots__ = ("name", "total", "record", "t0")

    def __init__(self, name: str, total: bool, traced: bool):
        self.name, self.total = name, total
        self.record = torch._C._profiler._RecordFunctionFast(name) if traced else None

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        with _lock:
            if self.record is not None:
                _add(_traced_spans, self.name, seconds)
            if self.total:
                _add(_totals, self.name, seconds)
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str, total: bool = False):
    """``with span("imgp.layer.phase"): ...``: a range in the profiler's
    trace and the traced registry while tracing is on; with ``total`` also
    the host seconds of every call in ``totals()``, tracing or not."""
    on = _autograd_profiler._is_profiler_enabled
    if not (on or total):
        return _OFF
    return _Span(name, total, on)


def spanned(name: str):
    """Decorator: the function's calls run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1):
    """Add ``n`` to the traced counter ``name`` while tracing is on."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _traced_counts[name] += n


def count_on_device(name: str, flags: torch.Tensor):
    """Add the sum of ``flags`` (a device tensor) to the traced counter
    ``name`` while tracing is on, without a host read: the sum is read when
    the registry is (``traced()``)."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _pending[name].append(flags.detach())


def traced() -> dict:
    """The traced registry: {"counters": {name: count}, "spans": {name:
    {"count", "seconds"}}}. Reads the device-side counts (one host read each)."""
    with _lock:
        for name, flags in _pending.items():
            _traced_counts[name] += sum(int(f.sum()) for f in flags)
        _pending.clear()
        return {"counters": dict(_traced_counts),
                "spans": {k: {"count": c, "seconds": s} for k, (c, s) in _traced_spans.items()}}


def totals() -> dict:
    """The always-on set-up spans: {name: {"count", "seconds"}}."""
    with _lock:
        return {k: {"count": c, "seconds": s} for k, (c, s) in _totals.items()}


def reset(include_totals: bool = False):
    """Empty the traced registry (and the totals with ``include_totals``)."""
    with _lock:
        _traced_counts.clear()
        _traced_spans.clear()
        _pending.clear()
        if include_totals:
            _totals.clear()


def counter_sum(counters: dict, prefix: str) -> int:
    """The sum of ``counters[prefix]`` and every ``counters[prefix.*]``."""
    return sum(v for k, v in counters.items() if k == prefix or k.startswith(prefix + "."))


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
    in chrome://tracing or Perfetto), and beside it ``counters_<time>.json``:
    the traced registry of the scope (emptied when it starts). Yields the
    profiler, or None when off."""
    if not enabled or not is_host_zero():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    stamp = time.time_ns()
    prof.export_chrome_trace(str(out / f"trace_{stamp}.json"))
    (out / f"counters_{stamp}.json").write_text(json.dumps(traced(), indent=1, sort_keys=True))
