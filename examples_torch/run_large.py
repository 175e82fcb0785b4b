#!/usr/bin/env python3
"""Serve the large-N IMGP campaign with the PyTorch port (prediction only).

The port's counterpart of ``examples/run_large.py``'s campaign with the
training left out: a torus sample in R^3 (262,144 points by default, 2,048
held out), labels y_true + 0.1 N(0,1) normalized by train statistics, an
exact kNN graph (k = 16) built on the device, the unit-bandwidth rescale and
bandwidth floor of the campaign, its InferenceConfig (block-ELL panels with
``use_dia=False``, the Chebyshev-filtered basis above ``eigh_max_size``),
then one basis solve and the evaluation tail: test RMSE/NLL on the noisy
labels and the posterior mean's RMSE against the known truth.

The hyperparameters are given (default: the trained values of the 262k
torus campaign), not trained.

Usage:
  python examples_torch/run_large.py                 # 262,144 points, CUDA
  python examples_torch/run_large.py --n 8192 --cpu  # small run on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Trained hyperparameters of the 262k torus campaign (graphbandwidth,
# lengthscale, noise from its result record; outputscale: the last value in
# its per-epoch metrics log).
CAMPAIGN_HYPERS = {
    "graphbandwidth": 0.2374,
    "lengthscale": 3.38,
    "noise": 0.002788,
    "outputscale": 2.2967,
}


def curve_points(n: int, seed: int = 0):
    """Noisy closed 3D curve and its parameter t."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x = np.stack(
        [np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], axis=1
    ).astype(np.float32)
    x += (0.1 / n) * rng.standard_normal(x.shape).astype(np.float32)
    return x, t


def torus_points(n: int, seed: int = 0, big_r: float = 1.0, small_r: float = 0.4):
    """n samples uniform on the surface of a torus in R^3, with the (u, v)
    angles (v drawn from the area element by rejection)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
    v = np.empty(n, np.float32)
    filled = 0
    while filled < n:
        cand = rng.uniform(0.0, 2 * np.pi, 2 * (n - filled))
        acc = rng.uniform(0.0, 1.0, cand.shape[0]) < (
            (1.0 + (small_r / big_r) * np.cos(cand)) / (1.0 + small_r / big_r)
        )
        take = cand[acc][: n - filled]
        v[filled : filled + take.shape[0]] = take
        filled += take.shape[0]
    x = np.stack(
        [
            (big_r + small_r * np.cos(v)) * np.cos(u),
            (big_r + small_r * np.cos(v)) * np.sin(u),
            small_r * np.sin(v),
        ],
        axis=1,
    ).astype(np.float32)
    return x, u, v


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_campaign(n: int = 262_144, hypers: dict = CAMPAIGN_HYPERS,
                   device="cuda", k: int = 16, num_test: int = 2048,
                   num_modes: int = 100, seed: int = 0, nu: int = 2):
    """Build, solve the basis once and score the held-out points.

    Returns (result dict, params, model). The result holds the timings
    (host clock around work that ends in a device synchronize), the layout
    size, the SpMV kernel's launch count during the basis solve, and the
    metrics."""
    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.config import resolve_device
    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.parameters import GreaterThan
    from manifold_gp_torch.utils import test_model

    device = resolve_device(device)
    timings = {}
    rng = np.random.default_rng(seed)
    x_all, u_all, v_all = torus_points(n, seed=seed)
    y_true = np.sin(2 * u_all) + 0.5 * np.cos(3 * u_all) * np.sin(2 * v_all)
    y_noisy = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    test_idx = perm[:num_test]
    train_idx = np.sort(perm[num_test:])
    train_x, test_x = x_all[train_idx], x_all[test_idx]
    mu_y, std_y = y_noisy[train_idx].mean(), y_noisy[train_idx].std(ddof=1)
    train_y = (y_noisy[train_idx] - mu_y) / std_y
    test_y = (y_noisy[test_idx] - mu_y) / std_y
    test_y_true = (y_true[test_idx] - mu_y) / std_y

    t0 = time.perf_counter()
    graph = build_graph(train_x, k, knn_backend="device", device=device)
    _sync(device)
    timings["graph_build_s"] = time.perf_counter() - t0

    # Unit-bandwidth coordinate scaling, as in the campaign.
    sq_np = graph.sqdist.cpu().numpy()
    eps = 2.0 * float(np.sqrt(np.median(sq_np)))
    # divide by a device tensor: true f32 division, as the JAX campaign does
    # (a CUDA division by a host scalar multiplies by its reciprocal)
    eps2 = torch.tensor(np.float32(eps) ** 2, device=device)
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / eps2)
    train_x_s = train_x / eps
    test_x_s = test_x / eps
    cfg = InferenceConfig(
        max_cholesky=0, dense_operator_max_size=0, num_probes=48,
        lanczos_max_iter=24, cg_tolerance=1e-2, cg_max_iter=200,
        precond_type="pivchol", spmv_dtype="bfloat16",
        solve_cotangent="edge", use_dia=False, eigensolver="chebyshev",
    )
    # The reference's data-driven bandwidth floor: every node's nearest edge
    # weight stays above 1e-4.
    n_tr = train_x.shape[0]
    rows_np = graph.rows.cpu().numpy()
    cols_np = graph.cols.cpu().numpy()
    sq_np = graph.sqdist.cpu().numpy()
    min_edge = np.full(n_tr, np.inf, np.float32)
    np.minimum.at(min_edge, rows_np, sq_np)
    np.minimum.at(min_edge, cols_np, sq_np)
    gb_min = float(np.sqrt(min_edge.max() / (4.0 * np.log(1e4))))

    t0 = time.perf_counter()
    kernel = RiemannMaternKernel(
        nu=nu, x=train_x_s, nearest_neighbors=k,
        laplacian_normalization="randomwalk", num_modes=num_modes,
        bump_scale=10.0, cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(gb_min), device=device,
    )
    _sync(device)
    timings["layout_s"] = time.perf_counter() - t0
    layout = kernel.block_layout
    model = RiemannGP(train_x_s, train_y, kernel, cfg=cfg)
    params = model.init_params(
        noise=hypers["noise"], outputscale=hypers["outputscale"],
        graphbandwidth=hypers["graphbandwidth"], lengthscale=hypers["lengthscale"],
    )

    launches_before = cuda_spmv.launch_count
    t0 = time.perf_counter()
    basis = kernel.eval_basis(params)
    _sync(device)
    timings["basis_s"] = time.perf_counter() - t0
    basis_launches = cuda_spmv.launch_count - launches_before
    # test_model re-runs eval(); serve the solved basis instead of solving
    # it again.
    kernel.eval_basis = lambda p: basis

    t0 = time.perf_counter()
    rmse, nll = test_model(model, params, test_x_s, test_y, noisy_test=True)
    _sync(device)
    timings["eval_s"] = time.perf_counter() - t0
    post = model.posterior(params, test_x_s, noisy_posterior=False)
    mean = post.mean.cpu().numpy()
    rmse_true = float(np.sqrt(np.mean((mean - test_y_true) ** 2)))
    eigval = basis[0].cpu().numpy()
    result = {
        "n": n,
        "k": k,
        "num_modes": num_modes,
        "device": str(device),
        "num_edges": int(graph.num_edges),
        "max_blocks": int(layout.max_blocks),
        "num_row_blocks": int(layout.num_row_blocks),
        "panel_bytes_f32": int(layout.panel_elems * 4),
        "basis_spmv_launches": int(basis_launches),
        "graphbandwidth_floor": gb_min,
        "rmse_vs_truth": rmse_true,
        "rmse_noisy_test": rmse,
        "nll_noisy_test": nll,
        "noise_floor_rmse": float(0.1 / std_y),
        "eigval_head": [float(v) for v in eigval[:10]],
        "finite": bool(np.isfinite(mean).all() and np.isfinite(eigval).all()),
        **timings,
    }
    return result, params, model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--num-test", type=int, default=2048)
    ap.add_argument("--num-modes", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    result, _, _ = serve_campaign(
        n=args.n, device="cpu" if args.cpu else "cuda", num_test=args.num_test,
        num_modes=args.num_modes, seed=args.seed,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
