#!/usr/bin/env python3
"""Reference numbers for the port's check of the curve campaign, computed
with the JAX package on the CPU.

Runs the setup of ``examples/run_large.py::run_campaign(manifold="curve")``
(closed 1-D curve in R^3, split, label normalization, exact kNN graph at
k = 8, unit-bandwidth rescale, bandwidth floor, the curve's InferenceConfig:
DIA bands, f32, panel cotangents, 128 probes, 32 Lanczos steps, the host
f64 basis) with the Jacobi preconditioner and a tight CG tolerance, and
records

  * ``mll_loss`` and its gradients w.r.t. the four raw hyperparameters at
    the campaign's initial hyperparameters, with Rademacher probes drawn
    from a numpy seed (the port regenerates them);
  * the served test RMSE/NLL and the RMSE against the truth at the curve
    campaign's trained hyperparameters, on the host f64 basis.

``examples_torch/run_large.py`` holds the same pipeline in the PyTorch port;
its chip check holds its numbers to the ones this script writes.

  JAX_PLATFORMS=cpu python tests/_curve_pins.py --n 16384 --num-test 512 \\
      --out examples_torch/curve_pins.json
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

INITIAL_HYPERS = {"noise": 1e-2, "outputscale": 1.0, "graphbandwidth": 1.0,
                  "lengthscale": 1.0}
# tools/r5/campaign_262k_f64.json (bandwidth, lengthscale, noise) and the
# last outputscale in tools/r5/campaign_262k_f64_metrics.jsonl (step 49).
CURVE_HYPERS = {"graphbandwidth": 0.2325, "lengthscale": 3.0813, "noise": 0.003473,
                "outputscale": 1.9376}
RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")


def _curve_points():
    spec = importlib.util.spec_from_file_location("_run_large", ROOT / "examples" / "run_large.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.curve_points


def rademacher_numpy(seed: int, n: int, num_probes: int) -> np.ndarray:
    """The probes both packages use: +-1 float32 [n, num_probes]."""
    bits = np.random.default_rng(seed).integers(0, 2, (n, num_probes))
    return (2 * bits - 1).astype(np.float32)


def curve_pins_jax(n: int, num_test: int, probe_seed: int, cg_tolerance: float,
                   cg_max_iter: int, k: int = 8, num_modes: int = 50, seed: int = 0,
                   nu: int = 2) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_tpu.ops import engine
    from manifold_gp_tpu.ops.dia import DiaLayout
    from manifold_gp_tpu.ops.graph import build_graph
    from manifold_gp_tpu.parameters import GreaterThan
    from manifold_gp_tpu.utils import test_model

    rng = np.random.default_rng(seed)
    x_all, t_all = _curve_points()(n, seed=seed)
    y_true = np.sin(3 * t_all) + 0.5 * np.sin(7 * t_all)
    y_noisy = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    test_idx = perm[:num_test]
    train_idx = np.sort(perm[num_test:])
    train_x, test_x = x_all[train_idx], x_all[test_idx]
    mu_y, std_y = y_noisy[train_idx].mean(), y_noisy[train_idx].std(ddof=1)
    train_y = (y_noisy[train_idx] - mu_y) / std_y
    test_y = (y_noisy[test_idx] - mu_y) / std_y
    test_y_true = (y_true[test_idx] - mu_y) / std_y

    graph = build_graph(train_x, k, knn_backend="device")
    eps = 2.0 * float(np.sqrt(np.median(np.asarray(graph.sqdist))))
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / np.float32(eps) ** 2)
    train_x_s, test_x_s = train_x / eps, test_x / eps
    cfg = InferenceConfig(
        max_cholesky=0, dense_operator_max_size=0, num_probes=128,
        lanczos_max_iter=32, cg_tolerance=cg_tolerance, cg_max_iter=cg_max_iter,
        precond_type="jacobi", spmv_dtype="float32",
        solve_cotangent="panel", use_dia=True, eigensolver="host_f64",
    )
    n_tr = train_x.shape[0]
    sq_np = np.asarray(graph.sqdist)
    min_edge = np.full(n_tr, np.inf, np.float32)
    np.minimum.at(min_edge, np.asarray(graph.rows), sq_np)
    np.minimum.at(min_edge, np.asarray(graph.cols), sq_np)
    gb_min = float(np.sqrt(min_edge.max() / (4.0 * np.log(1e4))))
    kernel = RiemannMaternKernel(
        nu=nu, x=train_x_s, nearest_neighbors=k,
        laplacian_normalization="randomwalk", num_modes=num_modes,
        bump_scale=10.0, cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(gb_min),
    )
    layout = kernel.block_layout
    assert isinstance(layout, DiaLayout), type(layout)
    model = RiemannGP(train_x_s, jnp.asarray(train_y), kernel, cfg=cfg)

    probes = jnp.asarray(rademacher_numpy(probe_seed, n_tr, cfg.num_probes))
    # mll_loss draws its probes through this name; hand it the shared ones
    engine.rademacher_probes = lambda key, n_, p_, dtype=jnp.float32: probes
    params = model.init_params(**INITIAL_HYPERS)
    loss, grads = jax.value_and_grad(lambda p: model.mll_loss(p, key=jax.random.PRNGKey(0)))(
        params)
    train = {"hypers": dict(INITIAL_HYPERS), "loss": float(loss),
             "grads": {k_: float(grads[k_]) for k_ in RAW}}
    print("train", train, file=sys.stderr)

    params = model.init_params(**CURVE_HYPERS)
    basis = kernel.eval_basis(params)
    kernel.eval_basis = lambda p: basis
    rmse, nll = test_model(model, params, test_x_s, test_y, noisy_test=True)
    post = model.posterior(params, test_x_s, noisy_posterior=False)
    rmse_true = float(np.sqrt(np.mean((np.asarray(post.mean) - test_y_true) ** 2)))
    serve = {"hypers": dict(CURVE_HYPERS), "rmse_vs_truth": rmse_true,
             "rmse_noisy_test": float(rmse), "nll_noisy_test": float(nll),
             "noise_floor_rmse": float(0.1 / std_y),
             "eigval_head": [float(v) for v in np.asarray(basis[0])[:10]]}
    print("serve", serve, file=sys.stderr)
    return {
        "n": n, "num_test": num_test, "k": k, "num_modes": num_modes, "seed": seed,
        "probe_seed": probe_seed, "num_probes": cfg.num_probes,
        "cg_tolerance": cg_tolerance, "cg_max_iter": cg_max_iter,
        "num_edges": int(graph.num_edges), "num_offsets": layout.num_offsets,
        "halfwidth": layout.halfwidth, "num_padded": layout.num_padded,
        "train": train, "serve": serve,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--num-test", type=int, default=512)
    ap.add_argument("--probe-seed", type=int, default=2024)
    ap.add_argument("--cg-tolerance", type=float, default=1e-5)
    ap.add_argument("--cg-max-iter", type=int, default=2000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = {
        "source": "tests/_curve_pins.py (manifold_gp_tpu on the CPU, f32, matmul precision "
                  "highest, DIA bands, panel cotangents, Jacobi, host f64 basis)",
        # Loss: a matvec and a fixed number of Lanczos steps, no solve; the
        # two packages differ by f32 sum order only. Gradients: CG solves
        # stopped at cg_tolerance on both sides, in different sum orders;
        # each is held to grad_rtol of the largest of the four. Serve: the
        # same f64 basis solve on the same sqdists; the f32 posterior.
        "loss_rtol": 1e-4,
        "grad_rtol": 5e-3,
        "serve_rtol": 1e-3,
        **curve_pins_jax(args.n, args.num_test, args.probe_seed, args.cg_tolerance,
                         args.cg_max_iter),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
