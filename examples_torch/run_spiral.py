#!/usr/bin/env python3
"""The designed semisupervised benchmark at 10,010 points, with the PyTorch
port: the port's copy of ``examples/run_spiral.py``.

  * Manifold: a 1-D Archimedean spiral with ``windings`` turns, embedded in
    R^``ambient_dim`` by a random rotation, with small ambient noise.
    Adjacent windings lie ~1/windings apart in Euclidean space and a whole
    winding apart along the curve: a Euclidean kernel smears the target
    across windings, the kNN-graph Laplacian follows the curve.
  * Target: y = sin(freq * 2 pi u), smooth along the curve coordinate u.
  * Protocol: semisupervised. The graph covers all n points, ``num_labeled``
    of them carry labels; IMGP (``RiemannGP(labeled=...)``) trains with the
    full ``manifold_informed_train`` protocol on the labeled block's Schur
    complement (an inner CG on the unlabeled block per apply), and a vanilla
    RBF GP on the labeled points is the baseline (``vanilla_train``). Both,
    and the hybrid posterior (IMGP with the vanilla GP blended in away from
    the spiral, ``test_model(base_model=...)``), are scored by
    ``test_model`` on up to ``num_eval`` unlabeled points.

The set-up is the JAX example's: the same data (a private copy of
``spiral_dataset``), the unit rescale of the coordinates by 3.5 median kNN
spacings (here from the port's device kNN), the bandwidth floor, the same
InferenceConfig (``max_cholesky=1000`` puts the 1,001-labeled loss on the
iterative CG + SLQ path) and the same two trainings. At 10,010 points the
kNN graph takes the block-ELL layout, so training runs the forward kernel
and the panel-cotangent kernel inside the nested CG, and the basis solve
(10,010 > ``eigh_max_size``) runs block LOBPCG on the forward kernel.

``--check-pins`` applies the JAX example's rule to ``examples/spiral_pins.json``
(read as data): IMGP beats vanilla, and IMGP RMSE <= 1.2 x pin + 1e-4.
The result line carries the phase seconds, the epoch seconds, the kernel
launches by batch width, the inner and outer CG iteration counts and the
peak device memory.

Usage:
  python examples_torch/run_spiral.py --check-pins      # the pinned 30-epoch run, CUDA
  python examples_torch/run_spiral.py --n 2000 --num-labeled 200 --max-iter 3 --cpu
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PINS_PATH = ROOT / "examples" / "spiral_pins.json"


def spiral_dataset(n: int = 10_010, windings: float = 6.0, ambient_dim: int = 20,
                   freq: float = 9.0, noise: float = 0.005, seed: int = 1337):
    """Returns (x [n, ambient_dim], y [n], u [n]): the spiral r = 1 + u at
    polar angle 2 pi windings u, u in [0, 1), rotated into R^ambient_dim."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
    theta = 2.0 * np.pi * windings * u
    r = 1.0 + u
    plane = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    q, _ = np.linalg.qr(rng.standard_normal((ambient_dim, 2)))
    x = plane @ q.T.astype(np.float32)
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    y = np.sin(freq * 2.0 * np.pi * u).astype(np.float32)
    return x.astype(np.float32), y, u


def build_problem(n: int = 10_010, num_labeled: int = 1001, windings: float = 6.0,
                  ambient_dim: int = 20, freq: float = 9.0, k: int = 10,
                  num_modes: int = 100, seed: int = 1337, num_eval: int = 2000,
                  device="cuda", **cfg_kw):
    """The semisupervised IMGP model and its data: (model, labeled mask,
    train_y, eval_x, eval_y). ``cfg_kw`` overrides the example's
    InferenceConfig fields."""
    import torch

    from manifold_gp_torch import (
        GreaterThan,
        InferenceConfig,
        RiemannGP,
        RiemannMaternKernel,
        resolve_device,
    )
    from manifold_gp_torch.ops.knn import knn_search

    device = resolve_device(device)
    x, y, _ = spiral_dataset(n=n, windings=windings, ambient_dim=ambient_dim, freq=freq,
                             seed=seed)
    rng = np.random.default_rng(seed)
    labeled = np.zeros(n, bool)
    labeled[rng.choice(n, num_labeled, replace=False)] = True
    y_noisy = y + 0.01 * rng.standard_normal(n).astype(np.float32)
    train_y = y_noisy[labeled]
    mu_y, std_y = train_y.mean(), train_y.std(ddof=1)
    train_y = (train_y - mu_y) / std_y
    unlabeled_idx = np.flatnonzero(~labeled)
    if unlabeled_idx.size > num_eval:
        unlabeled_idx = np.sort(rng.choice(unlabeled_idx, num_eval, replace=False))
    eval_x = x[unlabeled_idx]
    eval_y = (y_noisy[unlabeled_idx] - mu_y) / std_y

    # Unit-bandwidth rescale: 3.5 median kNN spacings become 1, so that the
    # initial bandwidth keeps sigma^2 ||Q|| < 1 and the 3-term Neumann noise
    # expansion definite (the JAX example's note).
    xt = torch.as_tensor(x, device=device)
    ev = knn_search(xt, xt, k, self_query=True)[0][:, 1:].cpu().numpy()
    unit = 3.5 * float(np.median(np.sqrt(ev).mean(axis=1)))
    x, eval_x = x / unit, eval_x / unit
    gb_min = math.sqrt(float(ev[:, 0].max()) / (4.0 * math.log(1e4)))
    cfg = InferenceConfig(**{**dict(max_cholesky=1000, cg_tolerance=1e-2, cg_max_iter=1000,
                                    num_probes=64, lanczos_max_iter=64), **cfg_kw})
    kernel = RiemannMaternKernel(
        nu=2, x=x, nearest_neighbors=k, laplacian_normalization="randomwalk",
        num_modes=num_modes, cfg=cfg, graphbandwidth_constraint=GreaterThan(gb_min / unit),
        device=device,
    )
    model = RiemannGP(x[labeled], train_y, kernel, labeled=labeled,
                      noise_constraint=GreaterThan(1e-8), cfg=cfg)
    return model, labeled, train_y, eval_x, eval_y


def run_experiment(max_iter: int = 30, seed: int = 1337, verbose: bool = False,
                   device="cuda", handles: dict = None, **problem_kw) -> dict:
    """Both trainings and evaluations; returns the result record.
    ``handles``: a dict that receives the trained models and params
    (``model``, ``params``, ``vmodel``, ``vparams``)."""
    import torch

    from manifold_gp_torch import RBFKernel, VanillaGP
    from manifold_gp_torch.ops import cg, cuda_spmv
    from manifold_gp_torch.utils import (
        ReduceLROnPlateau,
        manifold_informed_train,
        test_model,
        vanilla_train,
    )

    from examples_torch import reference_protocol as rp

    cuda = torch.device(device).type == "cuda"
    clock = rp.device_clock(cuda)

    t0 = clock()
    model, labeled, train_y, eval_x, eval_y = build_problem(seed=seed, device=device,
                                                            **problem_kw)
    layout = model.kernel.block_layout
    setup_s = clock() - t0
    n_lab = int(labeled.sum())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rp.reset_launch_counts()
    cg.iteration_log = []
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=1.0,
                               lengthscale=1.0)
    epochs = rp.EpochClock(cuda)
    t0 = clock()
    try:
        params, loss, history = manifold_informed_train(
            model, params, lr=1e-1, max_iter=max_iter, tolerance=1e-2, update_norm=100,
            num_rand_vec=100,
            scheduler=ReduceLROnPlateau(factor=0.5, patience=50, threshold=1e-3),
            verbose=verbose, seed=seed, metrics=epochs,
        )
        train_s = clock() - t0
        train_log = cg.iteration_log
    finally:
        cg.iteration_log = None
    train_launches = rp.launch_snapshot()
    train_peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    print(f"[manifold] final loss {loss:.4f} ({train_s:.1f}s)", file=sys.stderr)
    before = cuda_spmv.launch_count
    t0 = clock()
    rmse, nll = test_model(model, params, eval_x, eval_y, noisy_test=True)
    imgp_eval_s = clock() - t0
    eval_launches = cuda_spmv.launch_count - before

    x_lab = model.train_x
    vmodel = VanillaGP(x_lab, train_y, RBFKernel(device=device), cfg=model.cfg)
    vparams = vmodel.init_params(noise=1e-2, outputscale=1.0, lengthscale=1.0)
    t0 = clock()
    vparams, vloss, _ = vanilla_train(vmodel, vparams, lr=1e-1, max_iter=max_iter,
                                      tolerance=1e-2, verbose=verbose, seed=seed)
    vrmse, vnll = test_model(vmodel, vparams, eval_x, eval_y, noisy_test=True)
    vanilla_s = clock() - t0
    # the hybrid posterior: IMGP with the vanilla GP blended in away from the
    # spiral (on it, the blend weight 1 - bump(distance) is near 0)
    t0 = clock()
    hrmse, hnll = test_model(model, params, eval_x, eval_y, noisy_test=True,
                             base_model=vmodel, base_params=vparams)
    hybrid_s = clock() - t0
    if handles is not None:
        handles.update(model=model, params=params, vmodel=vmodel, vparams=vparams)
    epoch_s = epochs.epoch_seconds()
    return {
        "n": model.kernel.graph.num_nodes,
        "num_labeled": n_lab,
        "k": model.kernel.nearest_neighbors,
        "num_modes": model.kernel.num_modes,
        "max_iter": max_iter,
        "device": str(model.device),
        "layout": type(layout).__name__ if layout is not None else "dense",
        "max_blocks": getattr(layout, "max_blocks", None),
        "num_row_blocks": getattr(layout, "num_row_blocks", None),
        "imgp_loss": loss,
        "imgp_rmse": rmse,
        "imgp_nll": nll,
        "vanilla_loss": vloss,
        "vanilla_rmse": vrmse,
        "vanilla_nll": vnll,
        "advantage": vrmse / max(rmse, 1e-12),
        "hybrid_rmse": hrmse,
        "hybrid_nll": hnll,
        "hypers": {name: float(fn(params).detach()) for name, fn in (
            ("noise", model.noise), ("outputscale", model.outputscale),
            ("graphbandwidth", model.kernel.graphbandwidth),
            ("lengthscale", model.kernel.lengthscale))},
        "setup_s": setup_s,
        "train_s": train_s,
        "epoch_s_median": statistics.median(epoch_s),
        "epoch_s_first": epoch_s[0],
        "imgp_eval_s": imgp_eval_s,
        "vanilla_s": vanilla_s,
        "hybrid_s": hybrid_s,
        "train_launches": train_launches,
        "eval_launches": eval_launches,
        # inner: the Schur operator's solves on the unlabeled block; outer:
        # the solves (and SLQ's) on the labeled block's Schur operator
        "inner_cg": rp.cg_summary([it for label, _, _, it in train_log if label == "schur_inner"]),
        "outer_cg": rp.cg_summary([it for label, rows, _, it in train_log
                                 if label is None and rows == n_lab]),
        "train_peak_mem_bytes": train_peak,
        "allocated_bytes_after_epoch": {"first": epochs.bytes[0], "last": epochs.bytes[-1]},
    }


def check_pins(result: dict, pins: dict) -> list:
    """The JAX example's rule: IMGP beats vanilla, and IMGP RMSE within 20 %
    of the pinned value (training is stochastic: probes and the Adam path).
    Returns the failures."""
    failures = []
    if not result["imgp_rmse"] < result["vanilla_rmse"]:
        failures.append("manifold advantage lost")
    if not result["imgp_rmse"] <= 1.2 * pins["imgp_rmse"] + 1e-4:
        failures.append(f"imgp_rmse {result['imgp_rmse']} vs pinned {pins['imgp_rmse']}")
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_010)
    ap.add_argument("--num-labeled", type=int, default=1001)
    ap.add_argument("--windings", type=float, default=6.0)
    ap.add_argument("--ambient-dim", type=int, default=20)
    ap.add_argument("--freq", type=float, default=9.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--num-modes", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--num-eval", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--check-pins", action="store_true",
                    help="hold the result to examples/spiral_pins.json (rc 1 on a miss)")
    args = ap.parse_args()
    result = run_experiment(
        max_iter=args.max_iter, seed=args.seed, verbose=args.verbose,
        device="cpu" if args.cpu else "cuda", n=args.n, num_labeled=args.num_labeled,
        windings=args.windings, ambient_dim=args.ambient_dim, freq=args.freq, k=args.k,
        num_modes=args.num_modes, num_eval=args.num_eval,
    )
    print(json.dumps(result))
    if args.check_pins:
        failures = check_pins(result, json.loads(PINS_PATH.read_text()))
        for msg in failures:
            print(f"# FAIL: {msg}", file=sys.stderr)
        print(f"# check-pins: {'FAIL' if failures else 'OK'}", file=sys.stderr)
        sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
