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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--num-test", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = {
        "source": "tests/_serve_pins.py (manifold_gp_tpu on the CPU, f32, "
                  "matmul precision highest)",
        # The port-vs-JAX tolerance of tests/test_torch_riemann_gp.py: the
        # two packages start the basis solve from different random blocks
        # and sum in different f32 orders.
        "rtol": 1e-3,
        **serve_campaign_jax(args.n, num_test=args.num_test),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
