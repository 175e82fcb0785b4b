"""The readers of the program's spans and counters: a traced run of each
small CPU cell reports every per-layer metric its cell lists that reads
the program's registry, equal to what the registry holds, and an untraced
run leaves the traced registry empty.

The traced runs record no shapes: on the CPU the profiler keeps every
operation's inputs alive when it records them (~16 GB for the small torus
cell), and these readers read no shape."""

from __future__ import annotations

import pytest
import torch

from _small import run_small, small_cell

from manifold_gp_torch.utils import metrics
from portbench.harness import spec

TRAIN_CELLS = ("torus262k-train", "curve262k-train")


def _counter(counters, prefix):
    return metrics.counter_sum(counters, prefix)


@pytest.fixture
def shapeless_profiler(monkeypatch):
    profile = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda *args, **kw: profile(*args, **{**kw, "record_shapes": False}))


@pytest.mark.parametrize("name", TRAIN_CELLS + ("torus262k-serve",))
def test_registry_readers_report_the_registry(name, shapeless_profiler):
    metrics.reset(include_totals=True)
    cell = small_cell(name)
    out = run_small(cell, trace=True)
    units, window_s = out["attempted"], out["window_s"]
    reg, totals = metrics.traced(), metrics.totals()
    counters = reg["counters"]
    values = {m: v["value"] for m, v in out["metrics"].items()}
    expected = {
        "layout_s": totals["imgp.layout.build"]["seconds"],
        "graph_tail_s": totals["imgp.graph.host_tail"]["seconds"],
    }
    syncs = _counter(counters, "host_sync") / units
    if name in TRAIN_CELLS:
        expected.update({
            "cg_iters_per_epoch": _counter(counters, "cg.iterations") / units,
            "cg_capped_share.train": 100.0 * _counter(counters, "cg.capped")
            / _counter(counters, "cg.solves"),
            "host_syncs_per_epoch": syncs,
            "normalize_share.train": 100.0 * reg["spans"]["imgp.train.normalize"]["seconds"]
            / window_s,
        })
        assert values["cg_iters_per_epoch"] > 0 and values["host_syncs_per_epoch"] > 0
    else:
        expected["host_syncs_per_standup"] = syncs
        assert counters["lobpcg.iterations"] == units * cell.config["inference"][
            "eigensolver_max_iter"]
    assert set(expected) <= set(cell.per_layer)
    assert {m: values[m] for m in expected} == pytest.approx(expected, rel=1e-12)
    assert totals["imgp.layout.build"]["count"] == 1
    metrics.reset(include_totals=True)


def test_untraced_run_leaves_the_registry_empty():
    metrics.reset(include_totals=True)
    out = run_small(small_cell("torus262k-train"))
    assert set(out["metrics"]) == set(spec.load_cell("torus262k-train").end_to_end)
    assert metrics.traced() == {"counters": {}, "spans": {}}
    assert set(metrics.totals()) >= {"imgp.graph.search", "imgp.graph.host_tail",
                                     "imgp.layout.build"}
    metrics.reset(include_totals=True)
