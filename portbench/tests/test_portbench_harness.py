"""The harness: cells, mixes, limits and readers found by name; the frozen
copies equal the port's originals; the result line's keys; no JAX in a run;
no run without a card."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import data, roofline, spec

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a kind of loop, a cell's limits and a
    per-layer reader dropped into a copy of the benchmark's folder are found
    by name, with only the benchmark file's entries added."""
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics", "loops"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "loops" / "replay.py").write_text(
        "from ..harness import check\n\n\nclass Loop:\n    kind = 'replay'\n\n\n"
        "def judge(ref, record, cell, inputs, seed, device):\n"
        "    return {'graph_edges_off': check.edges_off(ref, *record)}\n")
    (root / "traffic" / "replay-1.json").write_text(json.dumps({"loop": "replay"}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((root / "configs" / "torus262k.json").read_text())
    (root / "configs" / "torus65k.json").write_text(json.dumps(dict(config, n=65536)))
    (root / "traffic" / "train-cold-jobs5.json").write_text(json.dumps(
        {"loop": "train_jobs", "start": "initial_hypers", "epochs_per_job": 5,
         "checked_steps": 3, "lr": 0.1, "tolerance": 0.01, "num_rand_vec": 100}))
    (root / "limits" / "torus65k-train-cold.json").write_text(
        (root / "limits" / "torus262k-train.json").read_text())
    (root / "metrics" / "jobs_per_window.py").write_text(
        "def read(run):\n    return run.units / 5\n")
    bench["configs"].append({"name": "torus65k", "source": "x", "reduced": [],
                             "file": "portbench/configs/torus65k.json", "why": "x"})
    bench["workloads"].append({"name": "torus65k-train-cold", "config": "torus65k",
                               "traffic": "train-cold-jobs5", "chips": 1, "why": "x"})
    bench["end_to_end"][1]["workloads"].append("torus65k-train-cold")
    bench["per_layer"].append({"name": "jobs_per_window", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "trainer", "moves": "epoch_ms",
                               "workloads": ["torus65k-train-cold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("torus65k-train-cold", root=root)
    assert cell.config["n"] == 65536
    assert cell.traffic["start"] == "initial_hypers"
    assert cell.end_to_end == ("setup_s", "epoch_ms")
    assert "jobs_per_window" in cell.per_layer and "graph_s" in cell.per_layer
    assert spec.metric_reader("jobs_per_window", root=root)(
        type("Run", (), {"units": 20})()) == 4
    kind = spec.loop_kind(json.loads((root / "traffic" / "replay-1.json").read_text())["loop"],
                          root=root)
    assert kind.Loop.kind == "replay" and callable(kind.judge)
    assert spec.loop_kind("train_jobs").Loop.__module__ == "portbench.loops.train_jobs"
    # the committed cells still read as before from the copy
    assert spec.load_cell("torus262k-serve", root=root).end_to_end == ("setup_s", "predictor_s")


def test_every_cell_has_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end[0] == "setup_s" and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for name in cell.per_layer:
            assert callable(spec.metric_reader(name))
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()


def test_frozen_data_equals_the_campaigns():
    sys.path.insert(0, str(REPO))
    from examples_torch import run_large

    for manifold in ("torus", "curve"):
        ours = data.campaign_data(3000, 128, 7, manifold)
        theirs = run_large.campaign_data(3000, 128, 7, manifold)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_frozen_roofline_equals_the_ports():
    from manifold_gp_torch.utils import roofline as port

    block = {"format": "block", "nrb": 2032, "s_max": 22, "num_padded": 260096}
    dia = {"format": "dia", "num_padded": 261120, "num_offsets": 21, "halfwidth": 10}
    name = "NVIDIA H100 80GB HBM3"
    for batch in (1, 48, 100, 300):
        for panel in (2, 4):
            mv = port.matvec_bytes(block, batch, buf_dtype_bytes=panel)
            nbytes, flops = roofline.block_fwd(block, batch, panel)
            assert nbytes == mv["total"] + mv["index"]
            assert flops == port.matvec_flops(block, batch)
            ours = roofline.bound_s(nbytes, flops, roofline.card_peaks(name), panel == 2)
            assert ours * 1e3 == pytest.approx(port.bound_ms(nbytes, flops, panel, name)[0])
        nbytes, flops = roofline.block_bwd(block, batch, 4)
        assert nbytes == port.bwd_blocks_bytes(block, batch)["total"]
        nbytes, flops = roofline.dia_fwd(dia, batch, 4)
        assert nbytes == port.matvec_bytes(dia, batch)["total"]
        assert flops == port.matvec_flops(dia, batch)
    assert roofline.PEAKS == port._PEAKS


def test_result_line_has_the_contract_keys():
    from _small import run_small, small_cell

    from portbench import run

    out = run_small(small_cell("torus262k-train"))
    result, lines = run.result_line(out, {"platform": "gpu", "kind": "x", "count": 1})
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"setup_s", "epoch_ms"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert lines[-1].startswith("check ") and json.dumps(result)


def test_a_run_imports_no_jax(tmp_path):
    """A small CPU run of the harness in a fresh process: no loaded module
    has the top-level name jax, jaxlib, flax or manifold_gp_tpu."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from _small import run_small, small_cell\n"
        "run_small(small_cell('curve262k-train', n=1500))\n"
        "from portbench.run import forbidden_modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('FORBIDDEN', forbidden_modules())\n"
    ) % (str(REPO), str(pathlib.Path(__file__).parent))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = eval(proc.stdout.splitlines()[-2])
    assert "manifold_gp_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "manifold_gp_tpu"} & set(loaded)
    assert proc.stdout.splitlines()[-1] == "FORBIDDEN []"


def test_no_card_no_result():
    """Without a CUDA card the command exits with an error and prints no
    result; it does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "torus262k-train", "--seed",
         str((1 << 31) + 5), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
