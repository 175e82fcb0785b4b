"""The reader of the Schur code's index gathers and scatters
(``metrics/schur_gathers_per_epoch.py``): a value per epoch where the
program counts ``schur.gathers``, none where it does not."""

from __future__ import annotations

from portbench.harness import registry, spec


def test_reader_reads_the_schur_gathers_counter(monkeypatch):
    counts = {"schur.gathers": 1_350}
    monkeypatch.setattr(registry, "counter", lambda prefix: counts.get(prefix))
    run = type("Run", (), {"units": 3})()
    assert spec.metric_reader("schur_gathers_per_epoch")(run) == 450.0
    counts.clear()  # a program without the counter: no reading
    assert spec.metric_reader("schur_gathers_per_epoch")(run) is None
