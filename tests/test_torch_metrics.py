"""The port's ``utils/metrics.py`` (the JAX package's metrics module has no
test of its own): the JSONL sink, the phase timer, the rank-0 check and the
``torch.profiler`` trace scope, against the JAX recorder's row format."""

import json

import torch

from manifold_gp_tpu.utils.metrics import MetricsRecorder as JRecorder
from manifold_gp_torch.utils import MetricsRecorder, phase_timer, profile_trace
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


def test_phase_timer_and_profile_trace(tmp_path):
    sink = {}
    for _ in range(2):
        with phase_timer("graph", sink):
            torch.ones(8).sum()
    assert set(sink) == {"graph"} and sink["graph"] > 0
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
