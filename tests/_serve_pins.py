#!/usr/bin/env python3
"""Reference numbers for the port's serving check, computed with the JAX
package on the CPU.

Runs the setup of ``examples/run_large.py::run_campaign`` (torus sample,
split, label normalization, exact kNN graph, unit-bandwidth rescale,
bandwidth floor, the campaign's InferenceConfig) with training left out:
the hyperparameters are given, the spectral basis is solved once and
``test_model`` scores the held-out points. ``examples_torch/run_large.py::
serve_campaign`` is the same pipeline in the PyTorch port; its chip check
holds its numbers to the ones this script writes.

  JAX_PLATFORMS=cpu python tests/_serve_pins.py --n 16384 --num-test 512 \
      --out examples_torch/serve_pins.json

It also writes ``pins_lobpcg``: the eigenvalues of the JAX package's block
LOBPCG (``lobpcg_smallest``, 200 iterations) on the same 16,384-point
Laplacian from a start block drawn by numpy, so the port can run its own
LOBPCG from the same block (``--lobpcg-only`` recomputes just that entry).
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Served hyperparameters: tools/r5/campaign_torus262k.json (bandwidth,
# lengthscale, noise) and the last outputscale logged in
# tools/r5/campaign_torus262k_metrics.jsonl (step 29).
CAMPAIGN_HYPERS = {
    "graphbandwidth": 0.2374,
    "lengthscale": 3.38,
    "noise": 0.002788,
    "outputscale": 2.2967,
}


def _torus_points():
    spec = importlib.util.spec_from_file_location(
        "_run_large", ROOT / "examples" / "run_large.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.torus_points


def serve_campaign_jax(n: int, hypers=CAMPAIGN_HYPERS, k: int = 16,
                       num_test: int = 2048, num_modes: int = 100,
                       seed: int = 0, nu: int = 2) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_tpu.ops.graph import build_graph
    from manifold_gp_tpu.parameters import GreaterThan
    from manifold_gp_tpu.utils import test_model

    rng = np.random.default_rng(seed)
    x_all, u_all, v_all = _torus_points()(n, seed=seed)
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
    graph = build_graph(train_x, k, knn_backend="device")
    graph_s = time.perf_counter() - t0
    eps = 2.0 * float(np.sqrt(np.median(np.asarray(graph.sqdist))))
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / np.float32(eps) ** 2)
    train_x_s = train_x / eps
    test_x_s = test_x / eps
    cfg = InferenceConfig(
        max_cholesky=0, dense_operator_max_size=0, num_probes=48,
        lanczos_max_iter=24, cg_tolerance=1e-2, cg_max_iter=200,
        precond_type="pivchol", spmv_dtype="bfloat16",
        solve_cotangent="edge", use_dia=False, eigensolver="chebyshev",
    )
    n_tr = train_x.shape[0]
    rows_np = np.asarray(graph.rows)
    cols_np = np.asarray(graph.cols)
    sq_np = np.asarray(graph.sqdist)
    min_edge = np.full(n_tr, np.inf, np.float32)
    np.minimum.at(min_edge, rows_np, sq_np)
    np.minimum.at(min_edge, cols_np, sq_np)
    gb_min = float(np.sqrt(min_edge.max() / (4.0 * np.log(1e4))))
    kernel = RiemannMaternKernel(
        nu=nu, x=train_x_s, nearest_neighbors=k,
        laplacian_normalization="randomwalk", num_modes=num_modes,
        bump_scale=10.0, cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(gb_min),
    )
    model = RiemannGP(train_x_s, jnp.asarray(train_y), kernel, cfg=cfg)
    params = model.init_params(
        noise=hypers["noise"], outputscale=hypers["outputscale"],
        graphbandwidth=hypers["graphbandwidth"],
        lengthscale=hypers["lengthscale"],
    )
    t0 = time.perf_counter()
    basis = jax.block_until_ready(kernel.eval_basis(params))
    basis_s = time.perf_counter() - t0
    kernel.eval_basis = lambda p: basis
    rmse, nll = test_model(model, params, test_x_s, test_y, noisy_test=True)
    post = model.posterior(params, test_x_s, noisy_posterior=False)
    rmse_true = float(np.sqrt(np.mean((np.asarray(post.mean) - test_y_true) ** 2)))
    layout = kernel.block_layout
    return {
        "n": n,
        "num_test": num_test,
        "k": k,
        "num_modes": num_modes,
        "seed": seed,
        "hypers": dict(hypers),
        "rmse_vs_truth": rmse_true,
        "rmse_noisy_test": rmse,
        "nll_noisy_test": nll,
        "noise_floor_rmse": float(0.1 / std_y),
        "eigval_head": [float(v) for v in np.asarray(basis[0])[:10]],
        "num_edges": int(graph.num_edges),
        "max_blocks": int(layout.max_blocks),
        "num_row_blocks": int(layout.num_row_blocks),
        "cpu_graph_s": graph_s,
        "cpu_basis_s": basis_s,
    }


# max |port - JAX| / bound allowed to the port's LOBPCG eigenvalues: four
# times the port's own CPU gap on the same start block (4.7e-6; an H100 read
# 2.5e-6): both runs stop at 200 iterations with the top of the block still
# converging, where f32 sum order moves the Ritz values.
LOBPCG_ATOL_OF_BOUND = 2e-5


def _port_lobpcg_gap(pins: dict) -> float:
    """The PyTorch port's ``lobpcg_smallest`` on the CPU, on its own build
    of the same graph and Laplacian (``examples_torch/run_large.py::
    lobpcg_eigvals``) from the same numpy start block: max |port - JAX| /
    bound over the eigenvalues."""
    from examples_torch.run_large import lobpcg_eigvals

    vals, bound = lobpcg_eigvals(pins, device="cpu")
    return float(np.max(np.abs(vals - np.asarray(pins["eigval"]))) / bound)


def lobpcg_pins_jax(n: int, num_test: int, hypers=CAMPAIGN_HYPERS, k: int = 16,
                    num_modes: int = 100, seed: int = 0, x0_seed: int = 0,
                    max_iter: int = 200) -> dict:
    """``manifold_gp_tpu.ops.eigen.lobpcg_smallest`` on the campaign's
    symmetric Laplacian (the same graph, rescale and coefficients as
    ``serve_campaign_jax``; f32 block-ELL panels, the basis solve's
    operator) from a start block [n_train, num_modes] drawn by numpy
    (``default_rng(x0_seed).standard_normal``), so another package can draw
    the same block."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig, RiemannMaternKernel
    from manifold_gp_tpu.ops.eigen import lobpcg_smallest
    from manifold_gp_tpu.ops.graph import build_graph
    from manifold_gp_tpu.ops.laplacian import gershgorin_bound, laplacian_matvec
    from manifold_gp_tpu.ops.sparse_formats import assemble

    rng = np.random.default_rng(seed)
    x_all, _, _ = _torus_points()(n, seed=seed)
    rng.standard_normal(n)  # the label noise draw of serve_campaign_jax
    perm = rng.permutation(n)
    train_x = x_all[np.sort(perm[num_test:])]
    graph = build_graph(train_x, k, knn_backend="device")
    eps = 2.0 * float(np.sqrt(np.median(np.asarray(graph.sqdist))))
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / np.float32(eps) ** 2)
    cfg = InferenceConfig(max_cholesky=0, dense_operator_max_size=0, use_dia=False)
    kernel = RiemannMaternKernel(
        nu=2, x=train_x / eps, nearest_neighbors=k, laplacian_normalization="randomwalk",
        num_modes=num_modes, bump_scale=10.0, cfg=cfg, graph=graph,
    )
    params = kernel.init_params(graphbandwidth=hypers["graphbandwidth"],
                                lengthscale=hypers["lengthscale"])
    c = kernel.coeffs(params)
    block = (kernel.block_layout, assemble(kernel.block_layout, c.diag, c.triu))
    bound = gershgorin_bound(kernel.graph, c)
    x0 = np.random.default_rng(x0_seed).standard_normal(
        (graph.num_nodes, num_modes)).astype(np.float32)
    t0 = time.perf_counter()
    vals, _ = lobpcg_smallest(
        lambda v: laplacian_matvec(kernel.graph, c, v, "symmetric", block=block),
        jnp.asarray(x0), bound, max_iter=max_iter)
    vals = np.asarray(jax.block_until_ready(vals))
    return {
        "n": n, "num_test": num_test, "k": k, "seed": seed, "hypers": dict(hypers),
        "num_modes": num_modes, "x0_seed": x0_seed, "max_iter": max_iter,
        "num_edges": int(graph.num_edges), "bound": float(bound),
        "eigval": [float(v) for v in vals], "cpu_lobpcg_s": time.perf_counter() - t0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--num-test", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--lobpcg-only", action="store_true",
                    help="recompute only the pins_lobpcg entry of an existing --out file")
    args = ap.parse_args()
    lobpcg = {
        "source": "tests/_serve_pins.py::lobpcg_pins_jax (manifold_gp_tpu on the CPU)",
        # max |eigval difference| / bound allowed to the port: set from the
        # port's own CPU run on the same start block (tests/_serve_pins.py
        # --lobpcg-only prints it as port_cpu_max_diff_of_bound)
        "atol_of_bound": LOBPCG_ATOL_OF_BOUND,
        **lobpcg_pins_jax(args.n, args.num_test),
    }
    lobpcg["port_cpu_max_diff_of_bound"] = _port_lobpcg_gap(lobpcg)
    if args.lobpcg_only:
        result = json.loads(pathlib.Path(args.out).read_text())
        result["pins_lobpcg"] = lobpcg
        text = json.dumps(result, indent=1)
        print(json.dumps({k: v for k, v in lobpcg.items() if k != "eigval"}))
        pathlib.Path(args.out).write_text(text + "\n")
        return
    result = {
        "source": "tests/_serve_pins.py (manifold_gp_tpu on the CPU, f32, "
                  "matmul precision highest)",
        # The port-vs-JAX tolerance of tests/test_torch_riemann_gp.py: the
        # two packages start the basis solve from different random blocks
        # and sum in different f32 orders.
        "rtol": 1e-3,
        **serve_campaign_jax(args.n, num_test=args.num_test),
        "pins_lobpcg": lobpcg,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
