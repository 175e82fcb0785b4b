"""Port vs JAX: CG (solution and iteration count), its implicit gradient,
Lanczos, SLQ with its Hutchinson gradient, and the engine's exact / stochastic
dispatch (twin of tests/test_cg_slq.py).

Both packages run the same f32 recurrences on the same numpy inputs; they
differ by the sum order of their reductions. Well-conditioned dense SPD
matrices keep that difference from moving the iteration at which a column
converges, so iteration counts are required to be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from manifold_gp_tpu.config import InferenceConfig as JConfig
from manifold_gp_tpu.ops import cg as jcg
from manifold_gp_tpu.ops import engine as jengine
from manifold_gp_tpu.ops import slq as jslq
from manifold_gp_torch.config import InferenceConfig as TConfig
from manifold_gp_torch.ops import cg as tcg
from manifold_gp_torch.ops import engine as tengine
from manifold_gp_torch.ops import slq as tslq
from manifold_gp_torch.ops.operator import Operator


def _spd(n, cond=50.0, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.linspace(1.0, cond, n)
    return ((q * evals) @ q.T).astype(np.float32)


def _rhs(n, batch, seed=1):
    return np.random.default_rng(seed).standard_normal((n, batch)).astype(np.float32)


def _rademacher(n, p, seed=2):
    return (2 * np.random.default_rng(seed).integers(0, 2, (n, p)) - 1).astype(np.float32)


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("tol", [1e-2, 1e-6])
def test_cg_raw_solution_and_iterations_match_jax(jacobi, tol):
    n = 80
    a = _spd(n, cond=30.0)
    a = a * np.linspace(1.0, 4.0, n)[:, None] * np.linspace(1.0, 4.0, n)[None, :]  # uneven diagonal
    a = ((a + a.T) / 2).astype(np.float32)
    b = _rhs(n, 4)
    b[:, 2] = 0.0  # the zero-column guard: solution 0, never active
    d = np.diagonal(a).copy()
    jx, jit = jcg.cg_raw(
        lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol, 400, with_info=True,
        precond=(lambda v: v / jnp.asarray(d)[:, None]) if jacobi else None)
    ta, td = torch.from_numpy(a), torch.from_numpy(d)
    tx, tit = tcg.cg_raw(
        lambda v: ta @ v, torch.from_numpy(b), tol, 400, with_info=True,
        precond=(lambda v: v / td[:, None]) if jacobi else None)
    assert isinstance(tit, int) and tit == int(jit)
    assert 0 < tit < 400
    scale = np.abs(np.asarray(jx)).max()
    # the iterates agree far below the stopping tolerance: same recurrence
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=2e-4 * scale)
    assert float(tx[:, 2].abs().max()) == 0.0


def test_cg_raw_x0_vector_shape_and_max_iter():
    n = 40
    a = _spd(n, cond=20.0)
    b = _rhs(n, 1)[:, 0]
    x0 = _rhs(n, 1, seed=5)
    ta = torch.from_numpy(a)
    jx, jit = jcg.cg_raw(lambda v: jnp.asarray(a) @ v, jnp.asarray(b[:, None]), 1e-5, 200,
                         x0=jnp.asarray(x0), with_info=True)
    tx, tit = tcg.cg_raw(lambda v: ta @ v, torch.from_numpy(b[:, None]), 1e-5, 200,
                         x0=torch.from_numpy(x0), with_info=True)
    assert tit == int(jit)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    x1 = tcg.cg_raw(lambda v: ta @ v, torch.from_numpy(b), 1e-6, 200)
    assert tuple(x1.shape) == (n,)
    np.testing.assert_allclose(x1.numpy(), np.linalg.solve(a, b), rtol=1e-3, atol=1e-4)
    _, capped = tcg.cg_raw(lambda v: ta @ v, torch.from_numpy(b), 1e-12, 3, with_info=True)
    assert capped == 3


def test_cg_solve_gradients_match_jax_and_dense():
    """Implicit-function backward: gradients w.r.t. a tensor of the operator
    and w.r.t. b, against JAX's custom VJP and an explicit dense solve."""
    n = 25
    a = _spd(n, cond=10.0)
    b = _rhs(n, 2)
    w = _rhs(n, 2, seed=3)
    d = np.diagonal(a).copy()

    def jf(theta, b_):
        mv = lambda v: jnp.asarray(a) @ v + theta * v  # noqa: E731
        x = jcg.cg_solve(mv, b_, tol=1e-8, max_iter=500,
                         precond=lambda v: v / (jnp.asarray(d) + theta)[:, None])
        return jnp.sum(jnp.asarray(w) * x)

    jg_theta, jg_b = jax.grad(jf, argnums=(0, 1))(jnp.float32(0.5), jnp.asarray(b))

    ta, tw, td = torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(d)
    theta = torch.tensor(0.5, requires_grad=True)
    tb = torch.from_numpy(b).requires_grad_(True)
    op = Operator(lambda v, a_, th: a_ @ v + th * v, (ta, theta))
    x = tcg.cg_solve(op, tb, tol=1e-8, max_iter=500,
                     precond=lambda v: v / (td + theta.detach())[:, None])
    tg_theta, tg_b = torch.autograd.grad(torch.sum(tw * x), (theta, tb))
    np.testing.assert_allclose(float(tg_theta), float(jg_theta), rtol=1e-4)
    np.testing.assert_allclose(tg_b.numpy(), np.asarray(jg_b), atol=1e-5)

    theta2 = torch.tensor(0.5, requires_grad=True)
    dense = torch.linalg.solve(ta + theta2 * torch.eye(n), torch.from_numpy(b))
    (dg,) = torch.autograd.grad(torch.sum(tw * dense), theta2)
    np.testing.assert_allclose(float(tg_theta), float(dg), rtol=1e-3)


def test_cg_solve_bare_callable_gets_gradient_for_b_only():
    n = 20
    ta = torch.from_numpy(_spd(n, cond=5.0))
    tb = torch.from_numpy(_rhs(n, 1)).requires_grad_(True)
    x = tcg.cg_solve(lambda v: ta @ v, tb, tol=1e-7, max_iter=200)
    (gb,) = torch.autograd.grad(x.sum(), tb)
    want = torch.linalg.solve(ta, torch.ones(n, 1))
    np.testing.assert_allclose(gb.numpy(), want.numpy(), rtol=1e-3, atol=1e-5)


def test_lanczos_coefficients_match_jax():
    n, p, m = 60, 5, 12
    a = _spd(n, cond=20.0)
    q0 = _rhs(n, p, seed=4)
    q0 /= np.linalg.norm(q0, axis=0, keepdims=True)
    ja, jb, jv = jslq.lanczos_batched(lambda v: jnp.asarray(a) @ v, jnp.asarray(q0), m)
    ta = torch.from_numpy(a)
    al, be, va = tslq.lanczos_batched(lambda v: ta @ v, torch.from_numpy(q0), m)
    assert tuple(al.shape) == (m, p) and va.dtype == torch.bool
    # no reorthogonalization: roundoff grows with the step, 12 steps stay tight
    np.testing.assert_allclose(al.numpy(), np.asarray(ja), rtol=2e-4)
    np.testing.assert_allclose(be.numpy(), np.asarray(jb), rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(va.numpy(), np.asarray(jv))


def test_lanczos_breakdown_is_flagged_like_jax():
    # rank-3 operator + identity: the Krylov space is exhausted after 4 steps
    n = 30
    rng = np.random.default_rng(8)
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0].astype(np.float32)
    a = (np.eye(n) + (u * np.array([3.0, 5.0, 9.0])) @ u.T).astype(np.float32)
    q0 = (u @ np.ones((3, 1)) + 0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    q0 /= np.linalg.norm(q0)
    ta = torch.from_numpy(a)
    quad_j = jslq.slq_logdet_raw(lambda v: jnp.asarray(a) @ v, jnp.asarray(q0), 10)
    quad_t = tslq.slq_logdet_raw(lambda v: ta @ v, torch.from_numpy(q0), 10)
    np.testing.assert_allclose(float(quad_t), float(quad_j), rtol=1e-4)


def test_slq_logdet_value_and_gradient_match_jax_with_shared_probes():
    n, p = 120, 32
    a = _spd(n, cond=10.0)
    probes = _rademacher(n, p)
    d = np.diagonal(a).copy()

    def jf(theta):
        return jslq.slq_logdet(
            lambda v: jnp.asarray(a) @ v + theta * v, jnp.asarray(probes), num_steps=30,
            cg_tol=1e-6, cg_max_iter=500, precond=lambda v: v / jnp.asarray(d)[:, None])

    jval, jgrad = jax.value_and_grad(jf)(jnp.float32(0.3))
    ta, td = torch.from_numpy(a), torch.from_numpy(d)
    theta = torch.tensor(0.3, requires_grad=True)
    op = Operator(lambda v, a_, th: a_ @ v + th * v, (ta, theta))
    tval = tslq.slq_logdet(op, torch.from_numpy(probes), num_steps=30, cg_tol=1e-6,
                           cg_max_iter=500, precond=lambda v: v / td[:, None])
    (tgrad,) = torch.autograd.grad(tval, theta)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=2e-5)
    np.testing.assert_allclose(float(tgrad), float(jgrad), rtol=1e-4)
    # and both estimate the exact quantities
    exact = float(np.linalg.slogdet(a + 0.3 * np.eye(n))[1])
    assert abs(float(tval.detach()) - exact) / abs(exact) < 0.05
    np.testing.assert_allclose(float(tgrad), np.trace(np.linalg.inv(a + 0.3 * np.eye(n))),
                               rtol=0.1)


def test_slq_num_nodes_scales_padded_probes():
    n, pad = 50, 14
    a = _spd(n, cond=6.0)
    big = np.eye(n + pad, dtype=np.float32)
    big[:n, :n] = a
    probes = np.concatenate([_rademacher(n, 8), np.zeros((pad, 8), np.float32)])
    tb = torch.from_numpy(big)
    jval = jslq.slq_logdet(lambda v: jnp.asarray(big) @ v, jnp.asarray(probes), 20, num_nodes=n)
    tval = tslq.slq_logdet(lambda v: tb @ v, torch.from_numpy(probes), 20, num_nodes=n)
    np.testing.assert_allclose(float(tval), float(jval), rtol=2e-5)


def test_rademacher_probes_from_a_generator():
    g = torch.Generator().manual_seed(3)
    z = tslq.rademacher_probes(g, 500, 6)
    assert z.dtype == torch.float32 and tuple(z.shape) == (500, 6)
    assert set(np.unique(z.numpy())) == {-1.0, 1.0}
    again = tslq.rademacher_probes(torch.Generator().manual_seed(3), 500, 6)
    assert torch.equal(z, again)
    assert abs(float(z.mean())) < 0.1


@pytest.mark.parametrize("exact", [True, False])
def test_engine_dispatch_matches_jax(exact, monkeypatch):
    """max_cholesky switches logdet / solve / average_variance between dense
    Cholesky and CG + SLQ; both regimes against JAX, the stochastic one with
    shared probes and indices."""
    n = 50
    a = _spd(n, cond=8.0)
    b = _rhs(n, 3)
    kw = dict(max_cholesky=100 if exact else 0, num_probes=16, lanczos_max_iter=20,
              cg_tolerance=1e-6, cg_max_iter=300)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    probes = _rademacher(n, 16)
    idx = np.random.default_rng(6).integers(0, n, 10)
    monkeypatch.setattr(jengine, "rademacher_probes", lambda key, n_, p_: jnp.asarray(probes))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(idx))
    jmv = lambda v: jnp.asarray(a) @ v  # noqa: E731
    ta = torch.from_numpy(a)
    tmv = Operator(lambda v, a_: a_ @ v, (ta,))
    key = jax.random.PRNGKey(0)

    jld = jengine.logdet(jmv, n, jcfg, key=key)
    tld = tengine.logdet(tmv, n, tcfg, probes=torch.from_numpy(probes))
    np.testing.assert_allclose(float(tld), float(jld), rtol=2e-5)
    if exact:
        np.testing.assert_allclose(float(tld), np.linalg.slogdet(a)[1], rtol=1e-4)

    jx = jengine.solve(jmv, jnp.asarray(b), n, jcfg)
    tx = tengine.solve(tmv, torch.from_numpy(b), n, tcfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(
        float(tengine.inv_quad(tmv, torch.from_numpy(b), n, tcfg)),
        float(jengine.inv_quad(jmv, jnp.asarray(b), n, jcfg)), rtol=1e-5)

    # all coordinates (num_rand_vec >= n), then 10 shared one-hot indices
    np.testing.assert_allclose(
        float(tengine.average_variance(tmv, n, 100, tcfg)),
        float(jengine.average_variance(jmv, n, 100, jcfg)), rtol=1e-5)
    jav = jengine.average_variance(jmv, n, 10, jcfg, key=key)
    tav = tengine.average_variance(tmv, n, 10, tcfg, idx=torch.from_numpy(idx))
    np.testing.assert_allclose(float(tav), float(jav), rtol=1e-5)
    np.testing.assert_allclose(float(tav), np.diagonal(np.linalg.inv(a))[idx].mean(), rtol=1e-3)


def test_engine_draws_from_a_generator_or_raises():
    n = 40
    ta = torch.from_numpy(_spd(n, cond=5.0))
    cfg = TConfig(max_cholesky=0, num_probes=8, lanczos_max_iter=10)
    mv = lambda v: ta @ v  # noqa: E731
    with pytest.raises(ValueError, match="Generator"):
        tengine.logdet(mv, n, cfg)
    with pytest.raises(ValueError, match="Generator"):
        tengine.average_variance(mv, n, 5, cfg)
    a1 = tengine.logdet(mv, n, cfg, generator=torch.Generator().manual_seed(1))
    a2 = tengine.logdet(mv, n, cfg, generator=torch.Generator().manual_seed(1))
    assert float(a1) == float(a2)
    v1 = tengine.average_variance(mv, n, 5, cfg, generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(v1))
