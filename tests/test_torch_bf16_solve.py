"""Port vs JAX: bf16 and x3 panels at the solve level (twin of
``tests/test_bf16_solve.py``). CG solutions under bf16 and x3 panels
against f32 panels, and 11 training epochs under bf16 panels against f32,
each at the JAX test's tolerance; beside them the port's solutions are held
to JAX's on the same inputs. The training draws JAX's probes and one-hot
indices (replayed from its key chains); JAX's own two trainings are not
run again here (``tests/test_bf16_solve.py`` runs them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_tpu.ops import slq as jslq
from manifold_gp_tpu.ops.cg import cg_solve as j_cg_solve
from manifold_gp_torch.ops.cg import cg_solve as t_cg_solve
from manifold_gp_torch.utils import ReduceLROnPlateau, manifold_informed_train

INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(2024)
    n = 900
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    x = centers[rng.integers(0, 4, n)] + 0.25 * rng.standard_normal((n, 8)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.5 * np.cos(x[:, 1])
    b = rng.standard_normal((n, 4)).astype(np.float32)
    return x, y.astype(np.float32), b


def _cfg(pkg, dtype):
    return pkg.InferenceConfig(max_cholesky=0, dense_operator_max_size=0, spmv_dtype=dtype,
                               cg_tolerance=1e-4, cg_max_iter=2000, num_probes=16,
                               lanczos_max_iter=30)


def _kernels(x, dtype):
    kw = dict(nu=2, x=x, nearest_neighbors=8, laplacian_normalization="randomwalk",
              num_modes=10)
    jk = J.RiemannMaternKernel(cfg=_cfg(J, dtype), **kw)
    tk = T.RiemannMaternKernel(cfg=_cfg(T, dtype), device="cpu", **kw)
    assert tk.block_layout is not None, "must exercise the fused block path"
    return jk, tk


def _solutions(x, b, dtype):
    jk, tk = _kernels(x, dtype)
    jsol = j_cg_solve(jk.precision_matvec(jk.init_params(graphbandwidth=0.3, lengthscale=1.0)),
                      jnp.asarray(b), tol=1e-6, max_iter=4000)
    with torch.no_grad():
        tsol = t_cg_solve(tk.precision_matvec(tk.init_params(graphbandwidth=0.3, lengthscale=1.0)),
                          torch.from_numpy(b), tol=1e-6, max_iter=4000)
    return np.asarray(jsol), tsol.numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def f32_solutions(clustered):
    x, _, b = clustered
    return _solutions(x, b, "float32")


def test_bf16_cg_solution_relative_error(clustered, f32_solutions):
    """Q^{-1} b under bf16 panels vs f32 panels: within the JAX test's
    1e-2; each dtype's solution within 1e-3 of JAX's."""
    x, _, b = clustered
    j32, t32 = f32_solutions
    j16, t16 = _solutions(x, b, "bfloat16")
    assert _rel(t16, t32) < 1e-2
    assert _rel(t32, j32) < 1e-3
    assert _rel(t16, j16) < 1e-3


def test_x3_cg_solution_relative_error(clustered, f32_solutions):
    """Q^{-1} b under float32x3 split panels vs f32: within the JAX test's
    1e-3; the x3 solution within 1e-4 of JAX's."""
    x, _, b = clustered
    j32, t32 = f32_solutions
    jx3, tx3 = _solutions(x, b, "float32x3")
    assert _rel(tx3, t32) < 1e-3
    assert _rel(tx3, jx3) < 1e-4


def test_bf16_training_hyperparameter_drift(clustered):
    """11 epochs of stochastic-path training under bf16 panels vs f32: the
    constrained hyperparameters within 2 % and the loss within 1e-2 (the
    JAX test's tolerances)."""
    x, y, _ = clustered
    n = x.shape[0]
    yn = (y - y.mean()) / y.std()
    kw = dict(lr=1e-2, max_iter=10, tolerance=0.0, update_norm=None, num_rand_vec=50)
    # JAX's probes and one-hot indices for seed 0, from its own key chains
    key, probes = jax.random.PRNGKey(0), []
    for _ in range(kw["max_iter"] + 1):
        key, sub = jax.random.split(key)
        probes.append(np.asarray(jslq.rademacher_probes(sub, n, 16)))
    cb, idx = jax.random.PRNGKey(7919), {}
    for boundary in (0, kw["max_iter"] + 1):
        cb, sub = jax.random.split(cb)
        idx[boundary] = np.asarray(jax.random.randint(sub, (50,), 0, n))
    results = {}
    for dtype in ("float32", "bfloat16"):
        _, tk = _kernels(x, dtype)
        tm = T.RiemannGP(x, yn, tk, cfg=tk.cfg)
        tp, tloss, _ = manifold_informed_train(
            tm, tm.init_params(**INIT), scheduler=ReduceLROnPlateau(factor=0.5, patience=50),
            probes_fn=lambda e: probes[e], idx_fn=lambda e: idx[e], **kw)
        with torch.no_grad():
            results[dtype] = dict(loss=tloss, noise=float(tm.noise(tp)),
                                  outputscale=float(tm.outputscale(tp)),
                                  graphbandwidth=float(tk.graphbandwidth(tp)),
                                  lengthscale=float(tk.lengthscale(tp)))
    f32, bf16 = results["float32"], results["bfloat16"]
    for k in ("noise", "outputscale", "graphbandwidth", "lengthscale"):
        np.testing.assert_allclose(bf16[k], f32[k], rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(bf16["loss"], f32["loss"], rtol=1e-2, atol=5e-3)
