"""The semi-supervised cell (``loops/semisup_jobs.py``): its readers, and a
small run on the CPU that passes its check while the control and the
planted faults that stand out at that size fail it."""

from __future__ import annotations

from _small import run_small, small_cell

from portbench.harness import check, registry, spec

CELL = "torus262k-semisup-train"
# At 2,000 points (187 labeled) bf16 rounding inside the inner solves moves
# the loss 2.4e-2 from the reference's (f32 panels: 1.4e-6), and the port's
# 1e-2 inner solves leave the first gradient 1.5e-2 and the steps 2.9e-2
# from the gradient of tight ones; the committed limits are set for 26,010
# labeled nodes. The 1 % altered losses and half the probes stay inside
# the bf16 error at this size.
SMALL = {"loss_gap": 0.06, "grad_gap": 0.05, "step_gap": 0.08}


def test_readers_read_the_schur_counters(monkeypatch):
    counts = {"schur.applies": 650, "cg.iterations.schur_inner": 15_600}
    monkeypatch.setattr(registry, "counter", lambda prefix: counts.get(prefix))
    run = type("Run", (), {"units": 3})()
    assert spec.metric_reader("schur_applies_per_epoch")(run) == 650 / 3
    assert spec.metric_reader("schur_inner_iters_per_apply")(run) == 24.0
    counts.clear()  # a program without the counters: no reading
    assert spec.metric_reader("schur_applies_per_epoch")(run) is None
    assert spec.metric_reader("schur_inner_iters_per_apply")(run) is None


def test_small_run_passes_and_the_faults_fail():
    cell = small_cell(CELL, **SMALL)
    out = run_small(cell, control=True)
    assert out["verdict"][0] and out["failed"] == 0, out["verdict"]
    for kind in ("control", "half_rows", "flipped", "no_schur"):
        ok, rows = check.verdict(out["control"][kind], cell.limits["limits"])
        assert not ok, (kind, rows)
