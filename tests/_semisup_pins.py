#!/usr/bin/env python3
"""Reference numbers for the port's semisupervised check, computed with the
JAX package on the CPU.

Builds ``examples/run_spiral.py``'s problem (the spiral, its labeled split,
label normalization, unit rescale and bandwidth floor) with the JAX
package and takes two losses with their gradients w.r.t. every raw
hyperparameter:

  * ``semisup``: ``RiemannGP(labeled=...).mll_loss`` on the spiral at
    5,005 points with 500 labeled (N above ``dense_operator_max_size``, so
    the block-ELL path runs), in the stochastic regime (``max_cholesky=0``)
    with 8 shared Rademacher probes and 16 Lanczos steps, at the example's
    initial hyperparameters and at a second point;
  * ``vanilla``: the BBMM ``VanillaGP.mll_loss`` (CG and the mBCG log-det
    under rank-15 pivoted Cholesky) of an RBF GP on the 10,010-point
    spiral's 1,001 labeled points, 8 probes, 16 steps, at the example's
    initial hyperparameters (lengthscale 1) and at lengthscale 8.

At lengthscale 1 most kernel entries of a pivot's column round to nothing
against the diagonal, so after the first pivot most residual diagonals tie
exactly in f32 and the greedy pivoting takes the first of them; which
entries still subtract depends on the last bit of the squared distances, so
two implementations (or two BLAS builds) can pick different pivots. The
preconditioner M then differs, and with it the mBCG estimate of the log-det
(its gradient uses plain probes and CG solves, which do not depend on M).
So at the ``initial`` point the loss is not held to JAX's estimate
(``hold_loss`` false) but to the dense f64 loss (``exact_loss``, numpy
Cholesky of the same gram) within ``exact_rtol``: the largest relative
deviation of JAX's estimate from it over probe seeds 0-31, the spread the
estimator has whatever M is. Each point records JAX's ``pivots`` (the row of
each column's largest |L| entry). The ``wide`` point, whose kernel columns
stay above the rounding, holds both loss and gradients to JAX's.

Every CG runs at ``cg_tolerance`` = 1e-5 in both packages: at the
example's 1e-2 two packages can stop an inner CG one iteration apart and
the loss moves by about the tolerance. The probes are numpy Rademacher
draws from ``probe_seed`` (the SLQ probes [n_labeled, 8]; for the mBCG
log-det z1 [15, 8], z2 and zr [1,001, 8], with zm = L z1 + sqrt(d) z2 from
each package's own preconditioner), so the port regenerates them.
``chip_smoke.py`` phase 10a holds the card to this file.

  JAX_PLATFORMS=cpu python tests/_semisup_pins.py --out examples_torch/semisup_pins.json
"""

import argparse
import json
import math
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HYPERS = {
    "initial": {"noise": 1e-2, "outputscale": 1.0, "graphbandwidth": 1.0, "lengthscale": 1.0},
    "moved": {"noise": 5e-3, "outputscale": 2.0, "graphbandwidth": 1.3, "lengthscale": 0.7},
}
VANILLA_HYPERS = {
    "initial": ({"noise": 1e-2, "outputscale": 1.0, "lengthscale": 1.0}, False),
    "wide": ({"noise": 1e-2, "outputscale": 1.0, "lengthscale": 8.0}, True),
}
SEMISUP_RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")
VANILLA_RAW = ("raw_lengthscale", "raw_noise", "raw_outputscale", "mean_constant")
SPREAD_SEEDS = 32  # probe seeds behind the f64 hold's limit


def rademacher_numpy(seed: int, shapes):
    """The probes both packages use: one +-1 float32 array per shape, drawn
    in order from one numpy generator."""
    rng = np.random.default_rng(seed)
    return [(2 * rng.integers(0, 2, shape) - 1).astype(np.float32) for shape in shapes]


def _spiral_problem_jax(n, num_labeled, k, num_modes, seed, cfg):
    """examples/run_spiral.py's set-up with the JAX package: (model, x, labeled,
    train_y, unit)."""
    import jax.numpy as jnp

    from examples.run_spiral import spiral_dataset
    from manifold_gp_tpu import GreaterThan, RiemannGP, RiemannMaternKernel
    from manifold_gp_tpu.ops.knn import knn_search

    x, y, _ = spiral_dataset(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    labeled = np.zeros(n, bool)
    labeled[rng.choice(n, num_labeled, replace=False)] = True
    y_noisy = y + 0.01 * rng.standard_normal(n).astype(np.float32)
    train_y = y_noisy[labeled]
    train_y = (train_y - train_y.mean()) / train_y.std(ddof=1)
    ev = np.asarray(knn_search(x, x, k, self_query=True)[0])[:, 1:]
    unit = 3.5 * float(np.median(np.sqrt(ev).mean(axis=1)))
    x = x / unit
    gb_min = math.sqrt(float(ev[:, 0].max()) / (4.0 * math.log(1e4)))
    kernel = RiemannMaternKernel(nu=2, x=x, nearest_neighbors=k,
                                 laplacian_normalization="randomwalk", num_modes=num_modes,
                                 cfg=cfg, graphbandwidth_constraint=GreaterThan(gb_min / unit))
    model = RiemannGP(x[labeled], jnp.asarray(train_y), kernel, labeled=labeled,
                      noise_constraint=GreaterThan(1e-8), cfg=cfg)
    return model, x, labeled, train_y, unit


def semisup_pins(n, num_labeled, k, num_probes, lanczos, cg_tol, cg_max_iter, probe_seed,
                 seed):
    import jax
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig
    from manifold_gp_tpu.ops import engine

    cfg = InferenceConfig(max_cholesky=0, cg_tolerance=cg_tol, cg_max_iter=cg_max_iter,
                          num_probes=num_probes, lanczos_max_iter=lanczos)
    model, _, labeled, _, unit = _spiral_problem_jax(n, num_labeled, k, 100, seed, cfg)
    layout = model.kernel.block_layout
    (probes,) = rademacher_numpy(probe_seed, [(int(labeled.sum()), num_probes)])
    # mll_loss draws its probes through this name; hand it the shared ones
    engine.rademacher_probes = lambda key, n_, p_, dtype=jnp.float32: jnp.asarray(probes)
    out = {}
    for label, hypers in HYPERS.items():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.mll_loss(p, key=jax.random.PRNGKey(0))))(model.init_params(**hypers))
        out[label] = {"hypers": hypers, "loss": float(loss),
                      "grads": {k_: float(grads[k_]) for k_ in SEMISUP_RAW}}
        print("semisup", label, out[label], file=sys.stderr)
    return {"n": n, "num_labeled": num_labeled, "k": k, "num_probes": num_probes,
            "lanczos_max_iter": lanczos, "unit": unit,
            "layout": type(layout).__name__, "max_blocks": int(layout.max_blocks),
            "num_row_blocks": int(layout.num_row_blocks),
            "num_edges": int(model.kernel.graph.num_edges), "pins": out}


def _exact_loss_f64(model, params, x, y):
    """The vanilla loss from a numpy f64 Cholesky of the RBF gram of ``x``
    (float, per point), at the model's hyperparameter values."""
    s, sigma2 = float(model.outputscale(params)), float(model.noise(params))
    ls = float(model.kernel.lengthscale(params))
    x = np.asarray(x, np.float64)
    r = np.asarray(y, np.float64) - float(params["mean_constant"])
    n2 = np.sum(x * x, axis=1)
    sq = np.maximum(n2[:, None] + n2[None, :] - 2.0 * x @ x.T, 0.0)
    k = s * np.exp(-sq / (2.0 * ls * ls)) + sigma2 * np.eye(len(x))
    chol = np.linalg.cholesky(k)
    alpha = np.linalg.solve(k, r)
    n = len(x)
    return 0.5 * (r @ alpha + 2.0 * np.sum(np.log(np.diag(chol)))
                  + n * math.log(2.0 * math.pi)) / n


def vanilla_pins(n, num_labeled, k, num_probes, lanczos, cg_tol, cg_max_iter, probe_seed,
                 seed):
    import jax
    import jax.numpy as jnp

    from manifold_gp_tpu import InferenceConfig, RBFKernel, VanillaGP
    from manifold_gp_tpu.ops import pivchol

    cfg = InferenceConfig(max_cholesky=1000, cg_tolerance=cg_tol, cg_max_iter=cg_max_iter,
                          num_probes=num_probes, lanczos_max_iter=lanczos)
    _, x, labeled, train_y, unit = _spiral_problem_jax(n, num_labeled, k, 100, seed, cfg)
    n_lab = int(labeled.sum())
    shapes = [(cfg.precond_rank, num_probes), (n_lab, num_probes), (n_lab, num_probes)]
    hi = jax.lax.Precision.HIGHEST
    # the preconditioner's draws are the loss's arguments below
    draws = {}
    pivchol.LowRankDiagPrecond.sample = lambda self, key, p: (
        jnp.matmul(self.L, draws["z1"], precision=hi) + jnp.sqrt(self.d)[:, None] * draws["z2"])
    pivchol.LowRankDiagPrecond.unit_sample = lambda self, key, p: draws["zr"]
    model = VanillaGP(x[labeled], jnp.asarray(train_y), RBFKernel(), cfg=cfg)

    def loss(params, z1, z2, zr):
        draws.update(z1=z1, z2=z2, zr=zr)
        return model.mll_loss(params, key=jax.random.PRNGKey(0))

    value_and_grad, value = jax.jit(jax.value_and_grad(loss)), jax.jit(loss)

    def probes(s):
        return [jnp.asarray(z) for z in rademacher_numpy(s, shapes)]

    out = {}
    for label, (hypers, hold_loss) in VANILLA_HYPERS.items():
        params = model.init_params(**hypers)
        lval, grads = value_and_grad(params, *probes(probe_seed))
        mv, d0 = model._covar_matvec_and_diag(params)
        pobj = pivchol.make_pivchol_precond(mv, d0, cfg.precond_rank)
        out[label] = {"hypers": hypers, "hold_loss": hold_loss, "loss": float(lval),
                      "grads": {k_: float(grads[k_]) for k_ in VANILLA_RAW},
                      "pivots": np.argmax(np.abs(np.asarray(pobj.L)), axis=0).tolist()}
        if not hold_loss:
            exact = _exact_loss_f64(model, params, x[labeled], train_y)
            spread = [abs(float(value(params, *probes(s))) - exact) / abs(exact)
                      for s in range(SPREAD_SEEDS)]
            out[label].update(exact_loss=exact, exact_rtol=max(spread),
                              exact_rel_of_pin=abs(float(lval) - exact) / abs(exact),
                              spread_seeds=SPREAD_SEEDS)
        print("vanilla", label, out[label], file=sys.stderr)
    return {"n": n, "num_labeled": n_lab, "num_probes": num_probes, "lanczos_max_iter": lanczos,
            "precond_rank": cfg.precond_rank, "unit": unit, "pins": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe-seed", type=int, default=2026)
    ap.add_argument("--cg-tolerance", type=float, default=1e-5)
    ap.add_argument("--cg-max-iter", type=int, default=2000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    common = dict(k=10, num_probes=8, lanczos=16, cg_tol=args.cg_tolerance,
                  cg_max_iter=args.cg_max_iter, probe_seed=args.probe_seed, seed=1337)
    result = {
        "source": "tests/_semisup_pins.py (manifold_gp_tpu on the CPU, f32, matmul precision "
                  "highest; the examples/run_spiral.py set-up; semisup: the Schur SLQ loss at "
                  "5,005 points / 500 labeled, block-ELL; vanilla: the BBMM RBF loss at the "
                  "10,010-point spiral's 1,001 labeled points)",
        # Loss: the tolerance of PERF.md's parity metric; each gradient is
        # held to grad_rtol of the largest of its set.
        "loss_rtol": 1e-4,
        "grad_rtol": 5e-3,
        "probe_seed": args.probe_seed,
        "cg_tolerance": args.cg_tolerance,
        "cg_max_iter": args.cg_max_iter,
        "semisup": semisup_pins(5005, 500, **common),
        "vanilla": vanilla_pins(10_010, 1001, **common),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
