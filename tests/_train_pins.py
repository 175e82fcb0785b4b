#!/usr/bin/env python3
"""Reference numbers for the port's training check, computed with the JAX
package on the CPU.

Runs the setup of ``examples/run_large.py::run_campaign`` (torus sample,
split, label normalization, exact kNN graph, unit-bandwidth rescale,
bandwidth floor, the campaign's InferenceConfig with bf16 panels) with the
Jacobi preconditioner and a tight CG tolerance, and takes ``mll_loss`` and
its gradients w.r.t. the four raw hyperparameters at the campaign's initial
and at its trained hyperparameters, once with edge-space cotangents (the
campaign's, ``pins``), once with panel-space cotangents (``pins_panel``),
and once with edge-space cotangents and the campaign's rank-15
pivoted-Cholesky preconditioner (``precond_type="pivchol"``,
``pins_pivchol``). The preconditioner enters only the gradient's CG solves:
the pivchol loss equals the Jacobi one, and its gradients differ from
Jacobi's by what a solve stopped at ``cg_tolerance`` leaves.

Panel space: on a TPU the JAX package takes the panels' cotangent through
its custom VJP (``pallas_spmv.make_matvec_ad``); at this size its backward
takes the bf16 einsum branch, which rounds g and the gathered operand to
bf16, sums their products in f32 and rounds the result to bf16 once, the
arithmetic of the panel-cotangent kernel K3. On the CPU the package would
differentiate the plain einsum instead (g unrounded), so this script routes
the solves through ``make_matvec_ad`` with its forward kernel replaced by
the same product as the plain einsum (``block_sparse.matvec_permuted``:
bf16 panels, operand rounded to bf16, f32 sums), since Pallas needs a TPU.

The SLQ probes are Rademacher draws from a numpy seed, so the port
regenerates them instead of reading a large file.
``examples_torch/run_large.py`` holds the same pipeline in the PyTorch port;
its chip check holds its numbers to the ones this script writes.

  JAX_PLATFORMS=cpu python tests/_train_pins.py --n 16384 --num-test 512 \
      --out examples_torch/train_pins.json
"""

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from _serve_pins import CAMPAIGN_HYPERS, _torus_points  # noqa: E402

INITIAL_HYPERS = {"noise": 1e-2, "outputscale": 1.0, "graphbandwidth": 1.0,
                  "lengthscale": 1.0}
RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")


def rademacher_numpy(seed: int, n: int, num_probes: int) -> np.ndarray:
    """The probes both packages use: +-1 float32 [n, num_probes]."""
    bits = np.random.default_rng(seed).integers(0, 2, (n, num_probes))
    return (2 * bits - 1).astype(np.float32)


def _panel_vjp_on_cpu(kernel):
    """Route ``kernel``'s panel-space solves through the package's custom
    VJP, whose forward kernel runs as the plain einsum (see the module
    note)."""
    from manifold_gp_tpu.ops import block_sparse, pallas_spmv

    pallas_spmv._run_block_kernel = (
        lambda layout, blocks, pv, interpret=False: block_sparse.matvec_permuted(layout, blocks, pv))
    kernel.use_pallas = True


def train_pins_jax(n: int, num_test: int, probe_seed: int, cg_tolerance: float,
                   cg_max_iter: int, k: int = 16, num_modes: int = 100,
                   seed: int = 0, nu: int = 2, cotangent: str = "edge",
                   precond_type: str = "jacobi") -> dict:
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_tpu.ops import engine
    from manifold_gp_tpu.ops.graph import build_graph
    from manifold_gp_tpu.parameters import GreaterThan

    rng = np.random.default_rng(seed)
    x_all, u_all, v_all = _torus_points()(n, seed=seed)
    y_true = np.sin(2 * u_all) + 0.5 * np.cos(3 * u_all) * np.sin(2 * v_all)
    y_noisy = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    train_idx = np.sort(perm[num_test:])
    train_x = x_all[train_idx]
    mu_y, std_y = y_noisy[train_idx].mean(), y_noisy[train_idx].std(ddof=1)
    train_y = (y_noisy[train_idx] - mu_y) / std_y

    graph = build_graph(train_x, k, knn_backend="device")
    eps = 2.0 * float(np.sqrt(np.median(np.asarray(graph.sqdist))))
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / np.float32(eps) ** 2)
    train_x_s = train_x / eps
    cfg = InferenceConfig(
        max_cholesky=0, dense_operator_max_size=0, num_probes=48,
        lanczos_max_iter=24, cg_tolerance=cg_tolerance, cg_max_iter=cg_max_iter,
        precond_type=precond_type, spmv_dtype="bfloat16",
        solve_cotangent=cotangent, use_dia=False, eigensolver="chebyshev",
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
    if cotangent == "panel":
        _panel_vjp_on_cpu(kernel)
    model = RiemannGP(train_x_s, jnp.asarray(train_y), kernel, cfg=cfg)

    probes = jnp.asarray(rademacher_numpy(probe_seed, n_tr, cfg.num_probes))
    # mll_loss draws its probes through this name; hand it the shared ones
    engine.rademacher_probes = lambda key, n_, p_, dtype=jnp.float32: probes
    out = {}
    for label, hypers in (("initial", INITIAL_HYPERS), ("trained", CAMPAIGN_HYPERS)):
        params = model.init_params(**hypers)
        loss, grads = jax.value_and_grad(
            lambda p: model.mll_loss(p, key=jax.random.PRNGKey(0))
        )(params)
        out[label] = {"hypers": dict(hypers), "loss": float(loss),
                      "grads": {k_: float(grads[k_]) for k_ in RAW}}
        print(cotangent, precond_type, label, out[label], file=sys.stderr)
    layout = kernel.block_layout
    return {
        "n": n, "num_test": num_test, "k": k, "seed": seed, "probe_seed": probe_seed,
        "num_probes": cfg.num_probes, "cg_tolerance": cg_tolerance,
        "cg_max_iter": cg_max_iter, "num_edges": int(graph.num_edges),
        "max_blocks": int(layout.max_blocks), "num_row_blocks": int(layout.num_row_blocks),
        "pins": out,
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
        "source": "tests/_train_pins.py (manifold_gp_tpu on the CPU, f32, matmul precision "
                  "highest, bf16 panels; pins: edge cotangents, Jacobi; pins_panel: panel "
                  "cotangents through make_matvec_ad's bf16 branch, Jacobi; pins_pivchol: "
                  "edge cotangents, rank-15 pivoted Cholesky)",
        # Loss: a matvec and a fixed number of Lanczos steps, no solve; the
        # two packages differ by f32 sum order only. Gradients: CG solves
        # stopped at cg_tolerance on both sides, in different sum orders;
        # each gradient is held to grad_rtol of the largest of the four.
        "loss_rtol": 1e-4,
        "grad_rtol": 5e-3,
        **train_pins_jax(args.n, args.num_test, args.probe_seed, args.cg_tolerance,
                         args.cg_max_iter),
    }
    result["pins_pivchol"] = train_pins_jax(args.n, args.num_test, args.probe_seed,
                                            args.cg_tolerance, args.cg_max_iter,
                                            precond_type="pivchol")["pins"]
    # after the edge pins: the panel run patches the package's dispatch
    result["pins_panel"] = train_pins_jax(args.n, args.num_test, args.probe_seed,
                                          args.cg_tolerance, args.cg_max_iter,
                                          cotangent="panel")["pins"]
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
