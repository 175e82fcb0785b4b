"""Small CPU versions of the benchmark's cells, for the tests: the committed
cell with fewer points, a short window and a small basis."""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench.harness import spec

SEED = (1 << 31) + 12345  # larger than 32 signed bits hold, as run seeds may be

# Limits the small cells keep where the committed ones are set for 262,144
# points: the curve's first gradient and step read 4e-5 to 9e-5 at 2,000
# points (its Hutchinson terms are relatively larger), so its small cell
# keeps the limits the curve had at k = 8.
SMALL_LIMITS = {"curve262k-train": {"grad_gap": 1.2e-3, "step_gap": 1.8e-4}}


def small_cell(name: str, n: int = 2000, **limits):
    """The cell ``name`` at ``n`` points on the CPU: 128 held out, jobs of
    3 epochs, a 20-mode basis with 100 LOBPCG iterations; ``SMALL_LIMITS``
    and then ``limits`` replace limits of the committed file. A CPU run launches no CUDA
    kernel, so the least launches a stand-up must count is 0 here."""
    cell = spec.load_cell(name)
    config = dict(cell.config, n=n, num_test=128)
    config["inference"] = dict(config["inference"], eigh_max_size=0, eigensolver_max_iter=100)
    if cell.traffic["loop"] == "standup":
        config["num_modes"] = 20
    traffic = dict(cell.traffic)
    if "epochs_per_job" in traffic:
        traffic["epochs_per_job"] = 3
    committed = dict(cell.limits["limits"])
    if "launches_min" in committed:
        committed["launches_min"] = {"min": 0}
    limits = {**SMALL_LIMITS.get(name, {}), **limits}
    lim = dict(cell.limits, limits={**committed, **{k: {"max": v} for k, v in limits.items()}})
    return dataclasses.replace(cell, config=config, traffic=traffic, limits=lim)


def run_small(cell, control: bool = False, trace: bool = False, device=None):
    """``run.run_cell`` with a window of one unit of work, on the CPU unless
    ``device`` is given."""
    from portbench import run

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    return run.run_cell(cell, SEED, 0.1, trace, device or torch.device("cpu"),
                        control=control, setup_clock=lambda: time.perf_counter() - t0)
