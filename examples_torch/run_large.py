#!/usr/bin/env python3
"""The large-N IMGP campaign with the PyTorch port: serve it, or train it.

The port's counterpart of ``examples/run_large.py``'s campaign, in two
halves that share its set-up (``build_campaign``): a sample of 262,144
points (by default; 2,048 held out) on one of the campaign's two manifolds,
labels y_true + 0.1 N(0,1) normalized by train statistics, an exact kNN
graph built on the device, the unit-bandwidth rescale and bandwidth floor of
the campaign, and its InferenceConfig for that manifold:

  * ``manifold="torus"`` (default): a torus in R^3, k = 16, 100 modes,
    block-ELL panels (``use_dia=False``), bf16 panels, edge-space solve
    cotangents, 48 probes, 24 Lanczos steps, the Chebyshev-filtered basis;
  * ``manifold="curve"``: the closed 1-D curve in R^3, k = 8, 50 modes, DIA
    bands (``use_dia=True``; the RCM ordering has 21 diagonals), f32 bands,
    panel-space solve cotangents, 128 probes, 32 Lanczos steps, the float64
    shift-invert basis on the host (``eigensolver="host_f64"``: the curve's
    low band lies below the f32 assembly noise floor).

Both train with the campaign's preconditioner, a rank-15 pivoted Cholesky of
the composed operator (``precond_type="pivchol"``), rebuilt every 10 epochs
(``precond_refresh=10``), as ``examples/run_large.py`` does.

``serve_campaign``: given hyperparameters (default: the trained values of
the 262k torus campaign), one basis solve and the evaluation tail: test
RMSE/NLL on the noisy labels (the NLL exactly and with the reference's
stochastic metric) and the posterior mean's RMSE against the known truth;
optionally LOVE variances (``love_ranks``), pathwise posterior samples, and
another basis solver through the config (``--eigensolver lobpcg``, the
config default, serves the torus with block LOBPCG).

``train_campaign``: precision-form MLL training (``manifold_informed_train``)
from the campaign's initial hyperparameters, the same epochs again with the
Jacobi preconditioner beside them, then at the initial and at the trained
hyperparameters, for each preconditioner (pivoted Cholesky, Jacobi, and
spectral deflation where a basis is given): its build, CG iterations and one
loss-and-gradient (``precond_comparison``).

On several GPUs (``--mesh``, one process per GPU under ``torchrun``) the
kernel row-shards its block-ELL layout over the ranks (``parallel``):
``train_campaign`` and ``serve_campaign`` run on that mesh kernel, each
rank builds the same graph, and rank 0 prints the result.

``run_campaign``: the whole cycle of ``examples/run_large.py::run_campaign``
(graph and basis through the keyed on-disk caches, an IVF graph above
200,000 training points, training with checkpoints and resume, metrics to
JSONL, the posterior against the truth).

Usage:
  python examples_torch/run_large.py --manifold torus --cache-dir .mgp_cache  # campaign
  python examples_torch/run_large.py --campaign --n 8192 --epochs 5 --cpu     # small, CPU
  python examples_torch/run_large.py                 # serve 262,144 points, CUDA
  python examples_torch/run_large.py --n 8192 --cpu  # small serve on the CPU
  python examples_torch/run_large.py --eigensolver lobpcg --love-rank 100
  python examples_torch/run_large.py --train --n 262144 --epochs 3
  python examples_torch/run_large.py --train --n 4096 --epochs 2 --cpu
  python examples_torch/run_large.py --manifold curve --train --n 262144 --epochs 3
  torchrun --nproc-per-node=4 examples_torch/run_large.py --mesh --train --epochs 3
  torchrun --nproc-per-node=4 examples_torch/run_large.py --mesh --eigensolver lobpcg
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

# Trained hyperparameters of the 262k curve campaign (k = 16, host-f64
# basis; tools/r5/campaign_262k_f64.json and the last row of its metrics
# log for the outputscale).
CURVE_HYPERS = {
    "graphbandwidth": 0.2325,
    "lengthscale": 3.0813,
    "noise": 0.003473,
    "outputscale": 1.9376,
}

# Per-manifold settings that differ: neighbours, modes, served
# hyperparameters.
MANIFOLDS = {
    "torus": {"k": 16, "num_modes": 100, "hypers": CAMPAIGN_HYPERS},
    "curve": {"k": 8, "num_modes": 50, "hypers": CURVE_HYPERS},
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


def srmnist_points(n: int = 10_010, d: int = 64, seed: int = 0):
    """The SRMNIST-shaped cloud of ``bench.py::build_inputs``: n points in
    R^d around 10 Gaussian cluster centers (10 digits' worth of structure)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((10, d)).astype(np.float32) * 2.0
    return centers[rng.integers(0, 10, n)] + 0.3 * rng.standard_normal((n, d)).astype(
        np.float32)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Campaign:
    """The campaign's data, graph, model and set-up timings."""

    model: object
    cfg: object
    graph: object
    train_y: np.ndarray
    test_x: np.ndarray  # rescaled to unit bandwidth
    test_y: np.ndarray
    test_y_true: np.ndarray
    noise_floor_rmse: float
    gb_min: float
    timings: dict


def campaign_data(n: int, num_test: int, seed: int, manifold: str):
    """The campaign's sample of ``manifold``, labels y_true + 0.1 N(0, 1),
    the split and the label normalization by train statistics: (train_x,
    test_x, train_y, test_y, test_y_true, std_y)."""
    rng = np.random.default_rng(seed)
    if manifold == "torus":
        x_all, u_all, v_all = torus_points(n, seed=seed)
        y_true = np.sin(2 * u_all) + 0.5 * np.cos(3 * u_all) * np.sin(2 * v_all)
    else:
        x_all, t_all = curve_points(n, seed=seed)
        y_true = np.sin(3 * t_all) + 0.5 * np.sin(7 * t_all)
    y_noisy = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    test_idx = perm[:num_test]
    train_idx = np.sort(perm[num_test:])
    mu_y, std_y = y_noisy[train_idx].mean(), y_noisy[train_idx].std(ddof=1)
    return (x_all[train_idx], x_all[test_idx], (y_noisy[train_idx] - mu_y) / std_y,
            (y_noisy[test_idx] - mu_y) / std_y, (y_true[test_idx] - mu_y) / std_y, std_y)


def cloud_model(device="cuda", n: int = 10_010, k: int = 50, seed: int = 0, **cfg_overrides):
    """A supervised IMGP model on the SRMNIST-shaped cloud (``srmnist_points``)
    with labels sin(x_0) + 0.5 cos(x_1) normalized, the graph rescaled to unit
    bandwidth as the campaign's is, and the default config (block-ELL above
    4,096 points) with ``cfg_overrides``."""
    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.config import resolve_device
    from manifold_gp_torch.ops.graph import build_graph

    device = resolve_device(device)
    x = srmnist_points(n, seed=seed)
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1])
    y = ((y - y.mean()) / y.std()).astype(np.float32)
    graph = build_graph(x, k, device=device)
    eps = 2.0 * float(np.sqrt(np.median(graph.sqdist.cpu().numpy())))
    eps2 = torch.tensor(np.float32(eps) ** 2, device=device)
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / eps2)
    cfg = InferenceConfig().replace(**cfg_overrides)
    kernel = RiemannMaternKernel(nu=2, x=x / eps, nearest_neighbors=k,
                                 laplacian_normalization="randomwalk", num_modes=100, cfg=cfg,
                                 graph=graph, device=device)
    return RiemannGP(x / eps, y, kernel, cfg=cfg)


def build_campaign(n: int = 262_144, device="cuda", k: int = None, num_test: int = 2048,
                   num_modes: int = None, seed: int = 0, nu: int = 2,
                   manifold: str = "torus", graph_builder=None, mesh=None,
                   **cfg_overrides) -> Campaign:
    """The campaign up to the model: sample of ``manifold`` ("torus" or
    "curve"), split, label normalization, kNN graph (the exact search on the
    device, or ``graph_builder(train_x, k, device)``'s graph), unit-bandwidth
    rescale, bandwidth floor, the campaign's InferenceConfig for that
    manifold (with ``cfg_overrides`` replacing fields of it), kernel and
    model. ``k`` and ``num_modes`` default to the manifold's. ``mesh``: a
    ``parallel.mesh.Mesh``; the kernel then row-shards its layout over it
    (and the campaign runs on the mesh's device)."""
    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.config import resolve_device
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.parameters import GreaterThan

    device = mesh.device if mesh is not None else resolve_device(device)
    k = MANIFOLDS[manifold]["k"] if k is None else k
    num_modes = MANIFOLDS[manifold]["num_modes"] if num_modes is None else num_modes
    timings = {}
    train_x, test_x, train_y, test_y, test_y_true, std_y = campaign_data(
        n, num_test, seed, manifold)

    t0 = time.perf_counter()
    if graph_builder is None:
        graph = build_graph(train_x, k, knn_backend="device", device=device)
    else:
        graph = graph_builder(train_x, k, device)
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
    if manifold == "torus":
        cfg = InferenceConfig(
            max_cholesky=0, dense_operator_max_size=0, num_probes=48,
            lanczos_max_iter=24, cg_tolerance=1e-2, cg_max_iter=200,
            precond_type="pivchol", spmv_dtype="bfloat16",
            solve_cotangent="edge", use_dia=False, eigensolver="chebyshev",
        )
    else:
        cfg = InferenceConfig(
            max_cholesky=0, dense_operator_max_size=0, num_probes=128,
            lanczos_max_iter=32, cg_tolerance=1e-2, cg_max_iter=200,
            precond_type="pivchol", spmv_dtype="float32",
            solve_cotangent="panel", use_dia=True, eigensolver="host_f64",
        )
    cfg = cfg.replace(**cfg_overrides)
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
        graphbandwidth_constraint=GreaterThan(gb_min), device=device, mesh=mesh,
    )
    _sync(device)
    timings["layout_s"] = time.perf_counter() - t0
    model = RiemannGP(train_x_s, train_y, kernel, cfg=cfg)
    return Campaign(model=model, cfg=cfg, graph=graph, train_y=train_y, test_x=test_x_s,
                    test_y=test_y, test_y_true=test_y_true,
                    noise_floor_rmse=float(0.1 / std_y), gb_min=gb_min, timings=timings)


def mesh_twin(camp: Campaign, mesh, **cfg_overrides):
    """The campaign's model again, on ``mesh`` (a ``parallel.mesh.Mesh``):
    the same points, labels and graph, the campaign's config with
    ``cfg_overrides``, the kernel row-sharding its layout over the mesh."""
    from manifold_gp_torch import RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.parameters import GreaterThan

    kernel = camp.model.kernel
    cfg = camp.cfg.replace(**cfg_overrides)
    twin = RiemannMaternKernel(
        nu=kernel.nu, x=kernel.x, nearest_neighbors=kernel.nearest_neighbors,
        laplacian_normalization=kernel.laplacian_normalization, num_modes=kernel.num_modes,
        bump_scale=kernel.bump_scale, cfg=cfg, graph=camp.graph,
        graphbandwidth_constraint=GreaterThan(camp.gb_min), mesh=mesh,
    )
    return RiemannGP(camp.model.train_x, camp.model.train_y, twin, cfg=cfg)


def layout_record(camp: Campaign, n: int, k: int, num_modes: int) -> dict:
    """Sizes of the campaign's graph and layout: block-ELL (row blocks, S,
    f32 panel bytes) or DIA (D offsets, halfwidth W, padded rows Npd, the
    stored 128-lane band's bytes and the bytes of its D used lanes, f32)."""
    from manifold_gp_torch.ops.dia import BAND_WIDTH, DiaLayout

    kernel = camp.model.kernel
    layout = kernel.block_layout
    rec = {
        "n": n,
        "k": k,
        "num_modes": num_modes,
        "device": str(camp.model.device),
        "num_edges": int(camp.graph.num_edges),
        "graphbandwidth_floor": camp.gb_min,
    }
    if kernel.mesh is not None:
        tables = kernel._mesh_fused
        rec.update(layout="mesh_block_ell" if tables is not None else "mesh_ell_scan",
                   world_size=kernel.mesh.world_size, num_padded=kernel.n_padded)
        if tables is not None:
            rec.update(max_blocks=int(tables.s_max), num_row_blocks=int(tables.nrb),
                       halo=tables.halo)
    elif isinstance(layout, DiaLayout):
        rec.update(layout="dia", num_offsets=layout.num_offsets,
                   halfwidth=layout.halfwidth, num_padded=layout.num_padded,
                   band_bytes_f32=layout.num_padded * BAND_WIDTH * 4,
                   band_bytes_used_f32=layout.num_padded * layout.num_offsets * 4)
    else:
        rec.update(layout="block_ell", max_blocks=int(layout.max_blocks),
                   num_row_blocks=int(layout.num_row_blocks),
                   panel_bytes_f32=int(layout.panel_elems * 4))
    return rec


def launch_counts() -> dict:
    """The launch counters of the port's kernels: forward block-ELL SpMV
    (K1/K2), panel cotangent (K3), DIA band SpMV (K4), band cotangent (K5)."""
    from manifold_gp_torch.ops import cuda_spmv, dia

    return {"spmv_launches": cuda_spmv.launch_count,
            "bwd_blocks_launches": cuda_spmv.bwd_launch_count,
            "dia_launches": dia.dia_launch_count,
            "band_grad_launches": dia.dia_band_grad_launch_count}


def launches_since(before: dict) -> dict:
    return {key: value - before[key] for key, value in launch_counts().items()}


def launches_by_batch() -> dict:
    """The forward kernel's launches so far by batch width: {B: count}."""
    from manifold_gp_torch.ops import cuda_spmv

    return dict(cuda_spmv.launch_count_by_batch)


def serve_campaign(n: int = 262_144, hypers: dict = None,
                   device="cuda", k: int = None, num_test: int = 2048,
                   num_modes: int = None, seed: int = 0, nu: int = 2,
                   manifold: str = "torus", love_ranks=(),
                   num_samples: int = 0, mesh=None, **cfg_overrides):
    """Build, solve the basis once and score the held-out points, at
    ``hypers`` (default: the manifold's trained campaign values), with
    ``cfg_overrides`` replacing fields of the campaign's config (e.g.
    ``eigensolver="lobpcg"``, the config default, for the torus).

    Scores: RMSE/NLL on the noisy labels, exactly and with the reference's
    stochastic metric (``test_model(metric="reference")``, probes from a
    generator seeded with ``seed``), and the posterior mean's RMSE against
    the known truth. ``love_ranks``: also ``eval(love_rank=r)`` for each r
    and its predictive variances at the test points against the exact ones.
    ``num_samples``: also that many pathwise posterior samples at the test
    points (their mean against the posterior mean).

    Returns (result dict, params, model). The result holds the timings
    (host clock around work that ends in a device synchronize), the layout
    size, the kernels' launch counts during the basis solve (the forward
    kernel's also by batch width), and the metrics. ``mesh``: serve on a
    mesh kernel (``build_campaign``)."""
    import torch

    from manifold_gp_torch.utils import test_model

    hypers = MANIFOLDS[manifold]["hypers"] if hypers is None else hypers
    camp = build_campaign(n=n, device=device, k=k, num_test=num_test,
                          num_modes=num_modes, seed=seed, nu=nu, manifold=manifold,
                          mesh=mesh, **cfg_overrides)
    k, num_modes = camp.model.kernel.nearest_neighbors, camp.model.kernel.num_modes
    model, timings = camp.model, camp.timings
    kernel, device = model.kernel, model.device
    params = model.init_params(
        noise=hypers["noise"], outputscale=hypers["outputscale"],
        graphbandwidth=hypers["graphbandwidth"], lengthscale=hypers["lengthscale"],
    )

    before, before_by_batch = launch_counts(), launches_by_batch()
    t0 = time.perf_counter()
    basis = kernel.eval_basis(params)
    _sync(device)
    timings["basis_s"] = time.perf_counter() - t0
    basis_launches = launches_since(before)
    by_batch = {str(b): c - before_by_batch.get(b, 0)
                for b, c in sorted(launches_by_batch().items())
                if c != before_by_batch.get(b, 0)}
    # test_model re-runs eval(); serve the solved basis instead of solving
    # it again.
    kernel.eval_basis = lambda p: basis

    t0 = time.perf_counter()
    rmse, nll = test_model(model, params, camp.test_x, camp.test_y, noisy_test=True)
    _sync(device)
    timings["eval_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, nll_reference = test_model(model, params, camp.test_x, camp.test_y, noisy_test=True,
                                  metric="reference",
                                  generator=torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    timings["eval_reference_s"] = time.perf_counter() - t0
    post = model.posterior(params, camp.test_x, noisy_posterior=False)
    mean = post.mean.cpu().numpy()
    rmse_true = float(np.sqrt(np.mean((mean - camp.test_y_true) ** 2)))
    eigval = basis[0].cpu().numpy()
    extra = {}
    finite = bool(np.isfinite(mean).all() and np.isfinite(eigval).all())
    if love_ranks:
        var_exact = torch.diagonal(post.covar)
        extra.update(love={}, exact_var_range=[float(var_exact.min()), float(var_exact.max())])
    for rank in love_ranks:
        t0 = time.perf_counter()
        model.eval(params, love_rank=rank,
                   generator=torch.Generator(device=device).manual_seed(seed))
        _sync(device)
        eval_s = time.perf_counter() - t0
        var_love = torch.diagonal(model.posterior(params, camp.test_x).covar)
        diff = torch.abs(var_love - var_exact)
        extra["love"][str(rank)] = {
            "eval_s": eval_s, "var_max_rel": float(torch.max(diff / var_exact)),
            "var_max_diff_of_max": float(torch.max(diff) / torch.max(var_exact))}
        finite = finite and bool(torch.isfinite(var_love).all())
    if num_samples:
        t0 = time.perf_counter()
        samples = model.posterior_samples(
            params, camp.test_x, torch.Generator(device=device).manual_seed(seed + 1),
            num_samples)
        _sync(device)
        timings["samples_s"] = time.perf_counter() - t0
        # the sample mean's error in units of its standard error
        z = (samples.mean(dim=0) - post.mean) / (post.stddev / num_samples ** 0.5)
        extra.update(num_samples=num_samples, samples_shape=list(samples.shape),
                     samples_mean_max_z=float(torch.max(torch.abs(z))))
        finite = finite and bool(torch.isfinite(samples).all())
    result = {
        **layout_record(camp, n, k, num_modes),
        "manifold": manifold,
        "eigensolver": camp.cfg.eigensolver,
        "basis_spmv_launches": basis_launches["spmv_launches"],
        "basis_spmv_launches_by_batch": by_batch,
        "basis_dia_launches": basis_launches["dia_launches"],
        "rmse_vs_truth": rmse_true,
        "rmse_noisy_test": rmse,
        "nll_noisy_test": nll,
        "nll_noisy_test_reference": nll_reference,
        "noise_floor_rmse": camp.noise_floor_rmse,
        "eigval_head": [float(v) for v in eigval[:10]],
        **extra,
        "finite": finite,
        **timings,
    }
    return result, params, model


def lobpcg_eigvals(pins: dict, device="cuda"):
    """The port's ``lobpcg_smallest`` on the campaign's symmetric Laplacian
    (f32 block-ELL panels through the forward kernel, as ``eval_basis``
    applies it) from the numpy start block of ``pins`` (the
    ``pins_lobpcg`` entry of ``serve_pins.json``): (eigenvalues as numpy,
    the Gershgorin bound)."""
    import torch

    from manifold_gp_torch.ops.eigen import lobpcg_smallest
    from manifold_gp_torch.ops.laplacian import gershgorin_bound, laplacian_matvec
    from manifold_gp_torch.ops.sparse_formats import assemble

    camp = build_campaign(n=pins["n"], device=device, k=pins["k"], num_test=pins["num_test"],
                          num_modes=pins["num_modes"], seed=pins["seed"])
    kernel = camp.model.kernel
    params = kernel.init_params(graphbandwidth=pins["hypers"]["graphbandwidth"],
                                lengthscale=pins["hypers"]["lengthscale"])
    c = kernel.coeffs(params)
    block = (kernel.block_layout, assemble(kernel.block_layout, c.diag, c.triu))
    bound = gershgorin_bound(kernel.graph, c)
    x0 = np.random.default_rng(pins["x0_seed"]).standard_normal(
        (kernel.graph.num_nodes, pins["num_modes"])).astype(np.float32)
    with torch.no_grad():
        vals, _ = lobpcg_smallest(
            lambda v: laplacian_matvec(kernel.graph, c, v, "symmetric", block=block),
            torch.from_numpy(x0).to(kernel.device), bound, max_iter=pins["max_iter"])
    return vals.cpu().numpy(), float(bound)


INITIAL_HYPERS = {"noise": 1e-2, "outputscale": 1.0, "graphbandwidth": 1.0,
                  "lengthscale": 1.0}


def rademacher_numpy(seed: int, n: int, num_probes: int) -> np.ndarray:
    """SLQ probes from a numpy seed, +-1 float32 [n, num_probes]: the draw
    the pinned JAX numbers of ``train_pins.json`` were computed with."""
    bits = np.random.default_rng(seed).integers(0, 2, (n, num_probes))
    return (2 * bits - 1).astype(np.float32)


class EpochLog:
    """``metrics=`` recorder of ``manifold_informed_train``: keeps every
    epoch's values, with the host seconds since the previous record (each
    record follows a device synchronize: the loss is read on the host)."""

    def __init__(self):
        self.rows = []
        self._t = time.perf_counter()

    def record(self, epoch, **values):
        now = time.perf_counter()
        self.rows.append({"epoch": epoch, "seconds": now - self._t, **values})
        self._t = now


PRECOND_REFRESH = 10  # epochs between pivoted-Cholesky rebuilds (the campaign's)


def loss_and_grad(model, params, generator=None, probes=None, precond_override=None):
    """One ``mll_loss`` value and its gradients w.r.t. every raw parameter
    (None where the loss does not reach one): (float, {name: float})."""
    import torch

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = model.mll_loss(leaves, generator=generator, probes=probes,
                          precond_override=precond_override)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return float(loss.detach()), {
        k: None if g is None else float(g) for k, g in zip(names, grads)
    }


def cg_iterations(model, params, rhs, precond=None) -> int:
    """CG iterations of one solve with the composed noisy precision at the
    campaign's tolerance, preconditioned by ``precond`` (a preconditioner
    object), else by the config's, built on the composed operator as
    training's solves are."""
    import torch

    from manifold_gp_torch.ops.cg import cg_raw
    from manifold_gp_torch.parallel import use_mesh

    with torch.no_grad(), use_mesh(model.mesh):
        mv = model.precision_matvec(params)
        if precond is None:
            precond = model.precision_precond_obj(params, matvec=mv)
        _, iters = cg_raw(mv, model.support_rows(rhs), tol=model.cfg.cg_tolerance,
                          max_iter=model.cfg.cg_max_iter,
                          precond=None if precond is None else precond.apply, with_info=True)
    return iters


def build_precond(model, params, kind: str, basis=None):
    """The preconditioner ``kind`` ("jacobi", "pivchol" or "deflation", the
    last from ``basis``) for the composed noisy precision at ``params``, with
    the host seconds and kernel launches of its build."""
    device = model.device
    before = launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    if kind == "deflation":
        obj = model.deflation_precond(params, basis=basis)
    else:
        cfg = model.cfg
        model.cfg = cfg.replace(precond_type=kind)
        try:
            obj = model.build_precond(params)
        finally:
            model.cfg = cfg
    _sync(device)
    return obj, time.perf_counter() - t0, launches_since(before)


def precond_comparison(model, params, kinds=("pivchol", "jacobi"), basis=None,
                       num_columns: int = 0, seed: int = 0) -> dict:
    """For each preconditioner kind at ``params``: its build (seconds,
    launches), CG iterations on the labels y and on ``num_columns``
    Rademacher columns, and one loss-and-gradient with it passed in (as a
    ``precond_refresh`` epoch uses it: the build is not inside), with its
    seconds and launches. Every kind draws the same SLQ probes."""
    import torch

    from manifold_gp_torch.ops.slq import rademacher_probes

    device = model.device
    rhs = {"y": model.train_y}
    if num_columns:
        rhs["columns"] = rademacher_probes(torch.Generator(device=device).manual_seed(seed),
                                           model.num_data, num_columns)
    out = {}
    for kind in kinds:
        obj, build_s, build_launches = build_precond(model, params, kind, basis=basis)
        rec = {"build_s": build_s, "build_launches": build_launches,
               "cg_iters": {name: cg_iterations(model, params, r, precond=obj)
                            for name, r in rhs.items()}}
        generator = torch.Generator(device=device).manual_seed(seed + 1)
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        value, grads = loss_and_grad(model, params, generator=generator, precond_override=obj)
        _sync(device)
        rec.update(loss=value, grads=grads, seconds=time.perf_counter() - t0,
                   **launches_since(before))
        out[kind] = rec
    return out


def train_campaign(n: int = 262_144, epochs: int = 3, device="cuda", k: int = None,
                   num_test: int = 2048, num_modes: int = None, seed: int = 0,
                   nu: int = 2, lr: float = 1e-1, trained_hypers: dict = None,
                   verbose: bool = False, manifold: str = "torus",
                   deflation_bases: dict = None, mesh=None):
    """Train the campaign's hyperparameters for ``epochs`` epochs from its
    initial values with its preconditioner (pivoted Cholesky, rebuilt every
    ``PRECOND_REFRESH`` epochs), then the same epochs again with Jacobi; then
    compare the preconditioners (``precond_comparison``) at the initial
    values and at ``trained_hypers`` (default: the torus campaign's trained
    values, where CG runs long; for the curve, the values these epochs
    reached).

    ``deflation_bases``: {"initial" / "trained": basis or None} adds the
    spectral deflation at those points, from the given basis (at those
    hyperparameters) or, for None, from one solved here (timed).
    Returns (result dict, params, model): per-epoch loss, hyperparameters
    and seconds, CG iteration counts, the launch counts of the kernels per
    phase, and peak device memory. ``mesh``: train on a mesh kernel
    (``build_campaign``)."""
    import torch

    from manifold_gp_torch.utils import constrained_values, manifold_informed_train

    camp = build_campaign(n=n, device=device, k=k, num_test=num_test,
                          num_modes=num_modes, seed=seed, nu=nu, manifold=manifold, mesh=mesh)
    k, num_modes = camp.model.kernel.nearest_neighbors, camp.model.kernel.num_modes
    model, timings = camp.model, camp.timings
    device = model.device
    on_card = device.type == "cuda"
    y = model.train_y

    def train(precond_type, log):
        cfg = model.cfg
        model.cfg = cfg.replace(precond_type=precond_type)
        try:
            return manifold_informed_train(
                model, model.init_params(**INITIAL_HYPERS), lr=lr, weight_decay=0.0,
                max_iter=epochs - 1, tolerance=1e-2, num_rand_vec=100, verbose=verbose,
                seed=seed, metrics=log, precond_refresh=PRECOND_REFRESH)
        finally:
            model.cfg = cfg

    timings["cg_iters_initial"] = cg_iterations(model, model.init_params(**INITIAL_HYPERS), y)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    log = EpochLog()
    before = launch_counts()
    t0 = time.perf_counter()
    params, loss, history = train(camp.cfg.precond_type, log)
    _sync(device)
    timings["train_s"] = time.perf_counter() - t0
    train_counts = launches_since(before)
    timings["s_per_epoch"] = float(np.median([r["seconds"] for r in log.rows]))
    timings["cg_iters_after_training"] = cg_iterations(model, params, y)
    jacobi_log = EpochLog()
    _, _, jacobi_history = train("jacobi", jacobi_log)
    timings["jacobi_s_per_epoch"] = float(np.median([r["seconds"] for r in jacobi_log.rows]))

    if trained_hypers is None:
        trained_hypers = (CAMPAIGN_HYPERS if manifold == "torus" else
                          {key: value for key, value in constrained_values(model, params).items()
                           if key != "mean_constant"})
    gradients = {}
    for label, hypers in (("initial", INITIAL_HYPERS), ("trained", trained_hypers)):
        p = model.init_params(**hypers)
        kinds, basis, basis_s = ("pivchol", "jacobi"), None, None
        if deflation_bases is not None and label in deflation_bases:
            kinds, basis = kinds + ("deflation",), deflation_bases[label]
            if basis is None:
                _sync(device)
                t0 = time.perf_counter()
                basis = model.kernel.eval_basis(p)
                _sync(device)
                basis_s = time.perf_counter() - t0
        gradients[label] = precond_comparison(model, p, kinds=kinds, basis=basis,
                                              num_columns=model.cfg.num_probes, seed=seed)
        if basis_s is not None:
            gradients[label]["deflation"]["basis_s"] = basis_s
        del basis

    values = [v for g in gradients.values() for rec in g.values()
              for v in (rec["loss"], *rec["grads"].values()) if v is not None]
    result = {
        **layout_record(camp, n, k, num_modes),
        "manifold": manifold,
        "epochs": epochs,
        "trained_hypers": trained_hypers,
        "precond_type": camp.cfg.precond_type,
        "precond_refresh": PRECOND_REFRESH,
        "history": history,
        "final_loss": loss,
        "epoch_log": log.rows,
        "jacobi_history": jacobi_history,
        "jacobi_epoch_log": jacobi_log.rows,
        "train_launches": train_counts,
        "gradients": gradients,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else None,
        "finite": bool(np.isfinite(history).all() and np.isfinite(jacobi_history).all()
                       and np.isfinite(values).all()),
        **timings,
    }
    return result, params, model


IVF_MIN_TRAIN = 200_000  # the campaign builds an IVF graph above this many training points


def campaign_graph_backend(num_train: int, device):
    """The campaign's graph search for ``num_train`` points: (the backend
    string of the graph cache key, ``build_graph`` keywords). Above
    ``IVF_MIN_TRAIN`` points the IVF search with nlist = 2^round(log2(4
    sqrt(N))), nprobe 16 and 5 k-means iterations; else the exact search,
    "device" on a card and "host" on the CPU."""
    if num_train > IVF_MIN_TRAIN:
        nlist = 2 ** int(round(np.log2(4.0 * np.sqrt(num_train))))
        return (f"ivf-nlist{nlist}-nprobe16-it5",
                dict(knn_backend="ivf", ivf_nlist=nlist, ivf_nprobe=16, ivf_kmeans_iters=5))
    backend = "device" if device.type == "cuda" else "host"
    return backend, dict(knn_backend=backend)


def run_campaign(n: int = 262_144, k: int = 16, epochs: int = 50, num_test: int = 2048,
                 num_modes: int = 100, cache_dir: str = ".mgp_cache", checkpoint_every: int = 10,
                 precond_refresh: int = 10, lr: float = 1e-1, seed: int = 0,
                 verbose: bool = False, resume: bool = True, nu: int = 2, metrics_path=None,
                 manifold: str = "torus", device="cuda", probes_fn=None, idx_fn=None):
    """The campaign's full cycle (the port of ``examples/run_large.py::
    run_campaign``): the split and label normalization, the graph through
    the keyed cache (``cached_graph``, the search of
    ``campaign_graph_backend``), the unit-bandwidth rescale and the
    manifold's config (``build_campaign``), CG iterations at the initial
    hyperparameters, ``manifold_informed_train`` with ``precond_refresh``,
    checkpoints every ``checkpoint_every`` epochs in ``cache_dir`` and
    resume, metrics to the JSONL file ``metrics_path``, the basis through
    ``cached_eval_basis``, the held-out scores and the posterior mean's RMSE
    against the known truth (``value``). ``probes_fn`` / ``idx_fn``: the
    trainer's shared randomness (see ``manifold_informed_train``).

    A checkpoint written after the last epoch is not resumed (the trainer
    resumes only a run that has epochs left): a second call with the same
    arguments trains again from the same seed, and hits both caches: the
    training repeats bit for bit (the Laplacian's per-node sums are
    ``ops.laplacian.incident_sum``, with no atomic-order sum), so the
    trained bandwidth keys the same basis.

    Returns (result dict, params, model); the numbers are unrounded, the
    timings host seconds around work that ends in a device synchronize.
    ``epoch_s``: the seconds between the trainer's per-epoch records (the
    first one also holds the outputscale normalization and the first
    preconditioner build)."""
    import os

    import torch

    from manifold_gp_torch.config import resolve_device
    from manifold_gp_torch.ops.cg import cg_raw
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.utils import (
        MetricsRecorder,
        cached_eval_basis,
        cached_graph,
        manifold_informed_train,
        test_model,
    )

    device = resolve_device(device)
    graph_rec = {}

    def graph_builder(train_x, k_, dev):
        backend, kw = campaign_graph_backend(train_x.shape[0], dev)
        graph, hit = cached_graph(train_x, k_, cache_dir, knn_backend=backend, device=dev,
                                  builder=lambda: build_graph(train_x, k_, device=dev, **kw))
        graph_rec.update(graph_backend=backend, graph_cache_hit=hit)
        return graph

    camp = build_campaign(n=n, device=device, k=k, num_test=num_test, num_modes=num_modes,
                          seed=seed, nu=nu, manifold=manifold, graph_builder=graph_builder)
    model, kernel = camp.model, camp.model.kernel
    timings = {**camp.timings, **graph_rec}
    print(f"# graph[{graph_rec['graph_backend']}]: {timings['graph_build_s']:.2f}s "
          f"cache_hit={graph_rec['graph_cache_hit']} M={camp.graph.num_edges}", file=sys.stderr)
    params = model.init_params(**INITIAL_HYPERS)

    def cg_iters(p):
        # without a preconditioner, as examples/run_large.py counts them
        with torch.no_grad():
            _, it = cg_raw(model.precision_matvec(p), model.train_y, tol=model.cfg.cg_tolerance,
                           max_iter=model.cfg.cg_max_iter, with_info=True)
        return int(it)

    timings["cg_iters_initial"] = cg_iters(params)
    metrics = MetricsRecorder(path=metrics_path, verbose=False)
    ckpt = os.path.join(cache_dir, f"campaign_{manifold}_{n}_{k}_{seed}_v2.ckpt.npz")
    _sync(device)
    t0, wall0 = time.perf_counter(), time.time()
    params, loss, history = manifold_informed_train(
        model, params, lr=lr, weight_decay=0.0, max_iter=epochs - 1, tolerance=1e-2,
        num_rand_vec=100, verbose=verbose, seed=seed, metrics=metrics,
        checkpoint_path=ckpt, checkpoint_every=checkpoint_every, resume=resume,
        precond_refresh=precond_refresh, probes_fn=probes_fn, idx_fn=idx_fn)
    _sync(device)
    train_s = time.perf_counter() - t0
    stamps = [wall0] + [row["time"] for row in metrics.history]
    timings.update(train_s=train_s, s_per_epoch=train_s / max(epochs, 1),
                   epoch_s=list(np.diff(stamps)))
    timings["cg_iters_trained"] = cg_iters(params)
    print(f"# trained {epochs} epochs in {train_s:.1f}s, final loss {loss:.4f}", file=sys.stderr)

    t0 = time.perf_counter()
    basis, bhit = cached_eval_basis(kernel, params, cache_dir)
    _sync(device)
    timings.update(basis_s=time.perf_counter() - t0, basis_cache_hit=bhit)
    # test_model re-runs eval(): serve this basis instead of solving again
    kernel.eval_basis = lambda p: basis
    print(f"# basis: {timings['basis_s']:.2f}s cache_hit={bhit}", file=sys.stderr)
    t0 = time.perf_counter()
    rmse, nll = test_model(model, params, camp.test_x, camp.test_y, noisy_test=True)
    _sync(device)
    timings["eval_s"] = time.perf_counter() - t0
    post = model.posterior(params, camp.test_x, noisy_posterior=False)
    rmse_true = float(np.sqrt(np.mean((post.mean.cpu().numpy() - camp.test_y_true) ** 2)))
    with torch.no_grad():
        hypers = {"graphbandwidth_trained": float(kernel.graphbandwidth(params)),
                  "lengthscale_trained": float(kernel.lengthscale(params)),
                  "noise_trained": float(model.noise(params)),
                  "outputscale_trained": float(model.outputscale(params))}
    result = {
        "metric": "campaign_rmse_vs_ground_truth",
        "value": rmse_true,
        "manifold": manifold,
        "n": n,
        "k": k,
        "epochs": epochs,
        "num_modes": num_modes,
        "num_edges": int(camp.graph.num_edges),
        "final_loss": float(loss),
        "history": history,
        **hypers,
        "graphbandwidth_floor": camp.gb_min,
        "rmse_noisy_test": rmse,
        "nll_noisy_test": nll,
        "noise_floor_rmse": camp.noise_floor_rmse,
        **timings,
    }
    return result, params, model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--manifold", choices=sorted(MANIFOLDS), default="torus")
    ap.add_argument("--num-test", type=int, default=2048)
    ap.add_argument("--num-modes", type=int, default=None,
                    help="default: the manifold's (torus 100, curve 50)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--train", action="store_true",
                    help="train the hyperparameters instead of serving given ones")
    ap.add_argument("--campaign", action="store_true",
                    help="run the full campaign cycle (run_campaign); implied by --cache-dir "
                         "and --no-cache")
    ap.add_argument("--k", type=int, default=None,
                    help="neighbours (default: campaign 16, else the manifold's)")
    ap.add_argument("--cache-dir", default=None,
                    help="campaign: graph/basis cache and checkpoint directory "
                         "(default .mgp_cache)")
    ap.add_argument("--no-cache", action="store_true",
                    help="campaign: a throwaway cache directory (forces rebuilds)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--precond-refresh", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-1)
    ap.add_argument("--metrics", default=None, help="campaign: JSONL per-epoch metrics path")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: campaign 50, --train 3")
    ap.add_argument("--eigensolver", choices=("lobpcg", "chebyshev", "host_f64"), default=None,
                    help="serve: the basis solver (default: the manifold's)")
    ap.add_argument("--love-rank", type=int, action="append", default=[],
                    help="serve: also LOVE variances of this rank against the exact ones "
                         "(repeat for several ranks)")
    ap.add_argument("--mesh", action="store_true",
                    help="train or serve on a mesh kernel over the torch.distributed group "
                         "(launch with torchrun, one process per GPU)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.mesh:
        from manifold_gp_torch.parallel import init_distributed, make_mesh

        init_distributed(backend="gloo" if args.cpu else None)
        mesh = make_mesh(device=device)
    if mesh is not None and (args.campaign or args.cache_dir is not None or args.no_cache):
        ap.error("--mesh trains (--train) or serves; the campaign cycle runs on one device")
    if args.campaign or args.cache_dir is not None or args.no_cache:
        import shutil
        import tempfile

        cache_dir = args.cache_dir or ".mgp_cache"
        if args.no_cache:
            pathlib.Path(".mgp_cache").mkdir(exist_ok=True)
            cache_dir = tempfile.mkdtemp(prefix="nocache_", dir=".mgp_cache")
        try:
            result, _, _ = run_campaign(
                n=args.n, k=16 if args.k is None else args.k,
                epochs=50 if args.epochs is None else args.epochs, num_test=args.num_test,
                num_modes=100 if args.num_modes is None else args.num_modes,
                cache_dir=cache_dir, checkpoint_every=args.checkpoint_every,
                precond_refresh=args.precond_refresh, lr=args.lr, seed=args.seed,
                verbose=args.verbose, resume=not args.no_resume, metrics_path=args.metrics,
                manifold=args.manifold, device=device)
        finally:
            if args.no_cache:
                shutil.rmtree(cache_dir, ignore_errors=True)
    elif args.train:
        result, _, _ = train_campaign(
            n=args.n, epochs=3 if args.epochs is None else args.epochs, device=device,
            k=args.k, num_test=args.num_test,
            num_modes=args.num_modes, seed=args.seed,
            verbose=args.verbose and (mesh is None or mesh.rank == 0),
            manifold=args.manifold, mesh=mesh,
        )
    else:
        overrides = {} if args.eigensolver is None else {"eigensolver": args.eigensolver}
        result, _, _ = serve_campaign(
            n=args.n, device=device, k=args.k, num_test=args.num_test,
            num_modes=args.num_modes, seed=args.seed, manifold=args.manifold,
            love_ranks=tuple(args.love_rank), mesh=mesh, **overrides,
        )
    if mesh is None or mesh.rank == 0:
        print(json.dumps(result))


if __name__ == "__main__":
    main()
