"""The port's ``utils/metrics.py`` (the JAX package's metrics module has no
test of its own): the JSONL sink, the rank-0 check, spans and the
``torch.profiler`` trace scope with its counters file, against the JAX
recorder's row format."""

import json

import torch

from manifold_gp_tpu.utils.metrics import MetricsRecorder as JRecorder
from manifold_gp_torch.utils import MetricsRecorder, count, profile_trace, span
from manifold_gp_torch.utils import metrics
from manifold_gp_torch.utils.metrics import is_host_zero


def test_metrics_recorder_writes_the_jax_rows(tmp_path):
    ours, theirs = tmp_path / "t" / "m.jsonl", tmp_path / "j" / "m.jsonl"
    rec, jrec = MetricsRecorder(str(ours)), JRecorder(str(theirs))
    for step in range(3):
        for r in (rec, jrec):
            r.record(step, loss=1.5 - step, lr=0.1)
    rows = [json.loads(line) for line in ours.read_text().splitlines()]
    jrows = [json.loads(line) for line in theirs.read_text().splitlines()]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert [(r["step"], r["loss"]) for r in rows] == [(r["step"], r["loss"]) for r in jrows]
    assert rec.history == rows and is_host_zero()
    assert MetricsRecorder().history == []  # no path: history only


def test_span_and_profile_trace(tmp_path):
    """Set-up spans time every call; ``profile_trace`` empties the traced
    registry, records spans and counters in the trace, and writes them
    beside it."""
    metrics.reset(include_totals=True)
    for _ in range(2):
        with span("imgp.test.setup", total=True):
            torch.ones(8).sum()
    assert metrics.totals()["imgp.test.setup"]["count"] == 2
    assert metrics.totals()["imgp.test.setup"]["seconds"] > 0
    with profile_trace(str(tmp_path / "warm")):
        count("test.stale")
    with profile_trace(str(tmp_path / "trace")) as prof:
        with span("imgp.test.phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        count("test.items", 3)
    assert prof is not None
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "imgp.test.phase" for e in events)
    (written,) = (tmp_path / "trace").glob("counters_*.json")
    assert written.name[len("counters_"):] == trace.name[len("trace_"):]
    rows = json.loads(written.read_text())
    assert rows["counters"] == {"test.items": 3}
    assert rows["spans"]["imgp.test.phase"]["count"] == 1
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    metrics.reset(include_totals=True)
