#!/usr/bin/env python3
"""Rotated-MNIST experiments (supervised and semisupervised) with the
PyTorch port: the port's copy of ``examples/run_rmnist.py``.

Replicates the reference notebooks ``RMNIST_supervised_learning.ipynb`` and
``RMNIST_semisupervised_learning.ipynb`` on SRMNIST (10 digits x 1,001
rotations = 10,010 training images in R^784, 1,010 test images):
  supervised:     labeled = 1 % (100), the kernel graph over those 100
                  points (nu = 2, k = 50, 50 modes), the data-driven
                  bandwidth floor, gb init 2.0, 500 epochs, a vanilla RBF
                  GP beside it. Dense: no kernel launches.
  semisupervised: the graph over all 10,010 points, labeled = 10 % (1,001),
                  nu = 2, k = 50, 100 modes, bump_decay 0.01, gb init 0.5,
                  100 epochs, a vanilla Matern-2.5 GP beside it (1,001 >
                  max_cholesky = 1000: BBMM and the iterative eval). The
                  graph takes the block-ELL layout: training runs the
                  forward kernel and K3 inside the nested CG of the labeled
                  block's Schur complement, and the basis solve runs block
                  LOBPCG on the forward kernel.
Both score the hybrid posterior (IMGP with the vanilla GP blended in away
from the manifold) with ``test_model``.

The split and label draws are the notebooks': a CPU torch generator seeded
1337 (``reference_protocol.reference_split``), never the card's. Without a
local MNIST file the loader builds the digits surrogate (same shapes); the
result line names the data source.

``--check-pins`` applies the JAX example's rule: on the surrogate, the four
metrics within 0.05 (RMSE, absolute) and 0.15 (NLL) of
``examples/srmnist_surrogate_pins.json`` (read as data); with real MNIST,
of the reference notebooks' outputs.

Usage:
  python examples_torch/run_rmnist.py semisupervised --check-pins   # CUDA
  python examples_torch/run_rmnist.py supervised --max-iter 3 --cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SURROGATE_PINS = ROOT / "examples" / "srmnist_surrogate_pins.json"
# the reference notebooks' stored outputs (BASELINE.md), for real MNIST
MNIST_PINS = {
    "supervised": {"rmse_manifold": 0.2981, "nll_manifold": 0.5420,
                   "rmse_vanilla": 0.2784, "nll_vanilla": -2.6679},
    "semisupervised": {"rmse_manifold": 0.0191, "nll_manifold": -1.2322,
                       "rmse_vanilla": 0.0666, "nll_vanilla": -0.8721},
}
RMSE_TOL, NLL_TOL = 0.05, 0.15  # stochastic-logdet training and MC eval


def dataset_fingerprint(train_x, test_x, train_y) -> dict:
    """Shapes and sha256 of the arrays as float32 bytes: two builds of the
    dataset (two scipy versions) are the same data iff these agree."""
    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()

    return {"train_x_shape": list(train_x.shape), "test_x_shape": list(test_x.shape),
            "train_x_sha256": digest(train_x), "test_x_sha256": digest(test_x),
            "train_y_sha256": digest(train_y)}


def run_experiment(mode: str, max_iter: int = None, device="cuda", handles: dict = None,
                   cache_dir=None, verbose: bool = False) -> dict:
    """One notebook protocol end to end; returns the result record.
    ``handles``: a dict that receives the trained IMGP ``model`` and
    ``params`` and the ``dataset`` (train_x, test_x, train_y) that
    ``dataset_fingerprint`` takes."""
    import torch

    from manifold_gp_torch import (
        GreaterThan,
        InferenceConfig,
        MaternKernel,
        RBFKernel,
        RiemannGP,
        RiemannMaternKernel,
        VanillaGP,
        resolve_device,
    )
    from manifold_gp_torch.ops import cg
    from manifold_gp_torch.utils import (
        ReduceLROnPlateau,
        manifold_informed_train,
        rmnist_dataset,
        test_model,
        vanilla_train,
    )
    from manifold_gp_torch.utils.datasets import rmnist_is_real

    from examples_torch import reference_protocol as rp

    semisup = mode == "semisupervised"
    device = resolve_device(device)
    cuda = device.type == "cuda"
    clock = rp.device_clock(cuda)
    phases = {}

    t0 = clock()
    sampled_x, sampled_y, _, test_x, test_y, _ = rmnist_dataset(single_digit=True,
                                                                cache_dir=cache_dir)
    real = rmnist_is_real(cache_dir=cache_dir, single_digit=True)
    phases["dataset"] = clock() - t0
    n = sampled_x.shape[0]
    train_idx, _ = rp.reference_split(n, int((0.1 if semisup else 0.01) * n))
    train_x = sampled_x[train_idx]
    train_y, test_y = rp.normalize_labels(sampled_y[train_idx], test_y)
    print(f"labeled {train_x.shape[0]} / {n}", file=sys.stderr)

    cfg = InferenceConfig(max_cholesky=1000, cg_tolerance=1e-2, cg_max_iter=1000)
    t0 = clock()
    if semisup:
        kernel_x, labeled = sampled_x, train_idx
        num_modes, bump_decay, gb_init = 100, 0.01, 0.5
        gb_constraint = None
    else:
        kernel_x, labeled = train_x, None
        num_modes, bump_decay, gb_init = 50, 1.0, 2.0
        gb_min, _ = rp.knn_bandwidth(train_x, device)
        gb_constraint = GreaterThan(gb_min)
        print(f"graphbandwidth_min {gb_min:.4f}", file=sys.stderr)
    kernel = RiemannMaternKernel(
        nu=2, x=kernel_x, nearest_neighbors=50, laplacian_normalization="randomwalk",
        num_modes=num_modes, bump_scale=10.0, bump_decay=bump_decay,
        graphbandwidth_constraint=gb_constraint, cfg=cfg, device=device,
    )
    model = RiemannGP(train_x, train_y, kernel, labeled=labeled,
                      noise_constraint=GreaterThan(1e-8), cfg=cfg)
    phases["graph"] = clock() - t0
    layout = kernel.block_layout
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=gb_init,
                               lengthscale=1.0)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rp.reset_launch_counts()
    cg.iteration_log = []
    epochs = rp.EpochClock(cuda)
    t0 = clock()
    try:
        if semisup:
            params, loss, _ = manifold_informed_train(
                model, params, lr=1e-2, max_iter=max_iter or 100, tolerance=1e-2,
                update_norm=None, num_rand_vec=100,
                scheduler=ReduceLROnPlateau(factor=0.5, patience=50, threshold=1e-3),
                verbose=verbose, metrics=epochs,
            )
        else:
            params, loss, _ = manifold_informed_train(
                model, params, lr=1e-1, max_iter=max_iter or 500, tolerance=1e-2,
                update_norm=100, num_rand_vec=100,
                scheduler=ReduceLROnPlateau(factor=0.5, patience=100, threshold=1e-3),
                verbose=verbose, metrics=epochs,
            )
        phases["training"] = clock() - t0
        train_log = cg.iteration_log
    finally:
        cg.iteration_log = None
    train_launches = rp.launch_snapshot()
    train_peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    print(f"[manifold] final loss {loss:.4f} ({phases['training']:.1f}s)", file=sys.stderr)

    # vanilla baseline on the labeled points: RBF (supervised) / Matern-2.5
    # (semisupervised)
    t0 = clock()
    vkernel = MaternKernel(2.5, device=device) if semisup else RBFKernel(device=device)
    vmodel = VanillaGP(train_x, train_y, vkernel, cfg=cfg)
    vparams = vmodel.init_params(noise=1e-2, outputscale=1.0, lengthscale=1.0)
    vparams, _, _ = vanilla_train(vmodel, vparams, lr=1e-1, max_iter=max_iter or 100,
                                  tolerance=1e-2, verbose=verbose)
    vrmse, vnll = test_model(vmodel, vparams, test_x, test_y, noisy_test=True)
    phases["vanilla"] = clock() - t0

    # hybrid eval (both RMNIST notebooks pass base_model=model_vanilla); the
    # basis solve that test_model runs inside is timed on its own
    before = rp.launch_snapshot()
    solve_basis, basis_s = kernel.eval_basis, []

    def timed_basis(p):
        t = clock()
        out = solve_basis(p)
        basis_s.append(clock() - t)
        return out

    kernel.eval_basis = timed_basis
    t0 = clock()
    try:
        rmse, nll = test_model(model, params, test_x, test_y, noisy_test=True,
                               base_model=vmodel, base_params=vparams)
    finally:
        del kernel.eval_basis
    phases["basis"] = sum(basis_s)
    phases["eval"] = clock() - t0 - phases["basis"]
    after = rp.launch_snapshot()
    eval_launches = {b: c - before["forward_by_batch"].get(b, 0)
                     for b, c in after["forward_by_batch"].items()
                     if c != before["forward_by_batch"].get(b, 0)}
    if handles is not None:
        handles.update(model=model, params=params, dataset=(sampled_x, test_x, sampled_y))
    epoch_s = epochs.epoch_seconds()
    n_lab = int(train_idx.sum())
    return {
        "config": mode,
        "data": "mnist" if real else "surrogate-digits",
        "rmse_manifold": rmse,
        "nll_manifold": nll,
        "rmse_vanilla": vrmse,
        "nll_vanilla": vnll,
        "imgp_loss": loss,
        "n": kernel.graph.num_nodes,
        "num_labeled": n_lab,
        "loss_evaluations": len(epoch_s),
        "device": str(device),
        "layout": type(layout).__name__ if layout is not None else "dense",
        "max_blocks": getattr(layout, "max_blocks", None),
        "num_row_blocks": getattr(layout, "num_row_blocks", None),
        "hypers": {name: float(fn(params).detach()) for name, fn in (
            ("noise", model.noise), ("outputscale", model.outputscale),
            ("graphbandwidth", kernel.graphbandwidth), ("lengthscale", kernel.lengthscale))},
        "phase_s": phases,
        "epoch_s_median": statistics.median(epoch_s),
        "epoch_s_first": epoch_s[0],
        "train_launches": train_launches,
        "eval_forward_launches_by_batch": eval_launches,
        # inner: the Schur operator's solves on the unlabeled block; outer:
        # the solves (and SLQ's) on the labeled block's operator
        "inner_cg": rp.cg_summary([it for label, _, _, it in train_log
                                   if label == "schur_inner"]),
        "outer_cg": rp.cg_summary([it for label, rows, _, it in train_log
                                   if label is None and rows == n_lab]),
        "train_peak_mem_bytes": train_peak,
    }


def check_pins(result: dict, mode: str, real: bool):
    """The JAX example's rule: each of the four metrics within 0.05 (RMSE)
    or 0.15 (NLL) of its pin. Returns (failures, source of the pins)."""
    if real:
        pins, src = MNIST_PINS[mode], "reference notebook outputs (BASELINE.md)"
    else:
        pins = json.loads(SURROGATE_PINS.read_text())[mode]
        src = str(SURROGATE_PINS.relative_to(ROOT))
    failures = []
    for key, want in pins.items():
        tol = RMSE_TOL if key.startswith("rmse") else NLL_TOL
        if not abs(result[key] - want) <= tol:
            failures.append(f"{key}: got {result[key]:.4f}, pinned {want:.4f}")
    return failures, src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["supervised", "semisupervised"])
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU instead of CUDA")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--cache-dir", type=str, default=None,
                    help="where the dataset cache lives (default: the package's data/)")
    ap.add_argument("--check-pins", action="store_true",
                    help="hold the 4 metrics to the pinned rows (rc 1 on a miss)")
    args = ap.parse_args()
    result = run_experiment(args.mode, max_iter=args.max_iter,
                            device="cpu" if args.cpu else "cuda",
                            cache_dir=args.cache_dir, verbose=args.verbose)
    print(f"RMSE Vanilla: {result['rmse_vanilla']:.4f}")
    print(f"NLL Vanilla: {result['nll_vanilla']:.4f}")
    print(f"RMSE Geometric: {result['rmse_manifold']:.4f}")
    print(f"NLL Geometric: {result['nll_manifold']:.4f}")
    print(json.dumps(result))
    if args.check_pins:
        failures, src = check_pins(result, args.mode, result["data"] == "mnist")
        for msg in failures:
            print(f"# PIN MISMATCH vs {src}: {msg}", file=sys.stderr)
        print(f"# check-pins vs {src}: {'FAIL' if failures else 'OK'}", file=sys.stderr)
        sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
