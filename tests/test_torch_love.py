"""Port vs JAX: LOVE predictive variances, pathwise posterior samples, the
dense sampler and the reference's stochastic NLL (``test_model(metric=
"reference")``), each with the random draw of the JAX side passed in.

Both packages serve the same data (a fixed-seed noisy circle, not the
session ``rng``) with the same params dict and the same spectral basis,
JAX's dense eigh one handed to both kernels: this graph has a three-fold
near-zero eigenvalue cluster whose rotation differs between LAPACK builds,
and the randomwalk recovery does not commute with it (the two packages'
own bases give Z Z' 0.7 % apart). So the caches differ by f32 sum order
alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as jmgp
import manifold_gp_torch as tmgp
from manifold_gp_tpu.utils import sample_posterior as jax_sample_posterior
from manifold_gp_tpu.utils import test_model as jax_test_model
from manifold_gp_tpu.utils.evaluate import gaussian_nll as jax_gaussian_nll
from manifold_gp_tpu.utils.evaluate import gaussian_nll_stochastic as jax_nll_stochastic
from manifold_gp_torch.utils import (
    gaussian_nll,
    gaussian_nll_stochastic,
    grid_uniform,
    params_from_jax,
    sample_posterior,
)
from manifold_gp_torch.utils import test_model as torch_test_model

HYPERS = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)


@pytest.fixture(scope="module")
def fitted():
    """test_love.py's fixture data (default_rng(20240818), 160 points),
    in both packages."""
    rng = np.random.default_rng(20240818)
    n = 160
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    x = x.astype(np.float32)
    y = np.sin(3 * t).astype(np.float32)
    kw = dict(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
              num_modes=12)
    jk = jmgp.RiemannMaternKernel(cfg=jmgp.InferenceConfig(), **kw)
    jm = jmgp.RiemannGP(x, y, jk, cfg=jmgp.InferenceConfig())
    jp = jm.init_params(**HYPERS)
    tk = tmgp.RiemannMaternKernel(cfg=tmgp.InferenceConfig(), device="cpu", **kw)
    tm = tmgp.RiemannGP(x, y, tk, cfg=tmgp.InferenceConfig())
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jbasis = jk.eval_basis(jp)
    tbasis = tuple(torch.from_numpy(np.asarray(b).copy()) for b in jbasis)
    jk.eval_basis = lambda p: jbasis
    tk.eval_basis = lambda p: tbasis
    return jm, jp, tm, tp, x, y


def test_love_full_rank_matches_exact(fitted):
    """Twin of test_love.py::test_love_full_rank_matches_exact: love_rank >=
    n_train exhausts the Krylov space and reproduces the exact covariance
    (the JAX test's 2e-3 of its largest entry); the mean stays exact."""
    _, _, model, params, x, _ = fitted
    exact = model.eval(params).posterior(params, x, is_train=True)
    model.eval(params, love_rank=x.shape[0])
    love = model.posterior(params, x, is_train=True)
    scale = float(torch.max(torch.abs(exact.covar)))
    np.testing.assert_allclose(love.covar.numpy(), exact.covar.numpy(), atol=2e-3 * scale)
    np.testing.assert_allclose(love.mean.numpy(), exact.mean.numpy(), atol=1e-5)


def test_love_low_rank_underestimates_like_love(fitted):
    """Twin of test_love.py::test_love_low_rank_underestimates_like_love:
    rank 8 differs from exact, bounded by the prior covariance scale."""
    _, _, model, params, x, _ = fitted
    exact = model.eval(params).posterior(params, x, is_train=True)
    model.eval(params, love_rank=8)
    love = model.posterior(params, x, is_train=True)
    diff = float(torch.max(torch.abs(love.covar - exact.covar)))
    assert diff > 1e-4 * float(torch.max(torch.abs(love.covar)))
    z = model.kernel.features(params, model._cache["basis"], x, is_train=True)
    assert diff <= 1.5 * float(torch.max(torch.abs(model._cache["s"] * (z @ z.T))))
    assert bool(torch.isfinite(love.covar).all())


@pytest.mark.parametrize("rank", [8, 160])
def test_love_covariance_matches_jax(fitted, rank):
    """LOVE at a truncated rank (the approximation itself) and at full rank,
    with JAX's Lanczos start vector (``jax.random.normal(PRNGKey(0))``, the
    draw of its default ``love_key``) passed in: the covariances agree
    within 1e-4 of the largest prior covariance entry (f32 sum order through
    the Lanczos recurrence), the means within 1e-5."""
    jm, jp, tm, tp, x, _ = fitted
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (x.shape[0],), jnp.float32))
    jm.eval(jp, love_rank=rank)
    jpost = jm.posterior(jp, x, is_train=True)
    tm.eval(tp, love_rank=rank, love_v0=torch.from_numpy(v0.copy()))
    tpost = tm.posterior(tp, x, is_train=True)
    z = tm.kernel.features(tp, tm._cache["basis"], x, is_train=True)
    scale = float(torch.max(torch.abs(tm._cache["s"] * (z @ z.T))))
    np.testing.assert_allclose(tpost.covar.numpy(), np.asarray(jpost.covar), atol=1e-4 * scale)
    np.testing.assert_allclose(tpost.mean.numpy(), np.asarray(jpost.mean), atol=1e-5)


def test_love_draws_its_start_vector_from_a_generator(fitted):
    """Without ``love_v0`` the start vector comes from ``generator`` (seed 0
    on the model's device by default): two evals with equal seeds give the
    same covariance."""
    _, _, model, params, x, _ = fitted
    model.eval(params, love_rank=8)
    a = model.posterior(params, x[:20]).covar
    model.eval(params, love_rank=8, generator=torch.Generator().manual_seed(0))
    b = model.posterior(params, x[:20]).covar
    assert torch.equal(a, b)


def test_posterior_samples_match_moments(fitted):
    """Twin of test_models.py::test_posterior_samples_match_moments on this
    fixture: 20,000 pathwise samples and 20,000 dense-sampler draws
    reproduce the posterior mean and covariance (atol 2e-2, the JAX
    test's)."""
    _, _, model, params, x, _ = fitted
    model.eval(params)
    xq = x[:40]
    post = model.posterior(params, xq)
    s = model.posterior_samples(params, xq, torch.Generator().manual_seed(0), 20000)
    assert tuple(s.shape) == (20000, 40)
    np.testing.assert_allclose(s.mean(dim=0).numpy(), post.mean.numpy(), atol=2e-2)
    np.testing.assert_allclose(np.cov(s.numpy().T), post.covar.numpy(), atol=2e-2)
    s2 = sample_posterior(post, torch.Generator().manual_seed(1), 20000)
    np.testing.assert_allclose(s2.mean(dim=0).numpy(), post.mean.numpy(), atol=2e-2)
    np.testing.assert_allclose(np.cov(s2.numpy().T), post.covar.numpy(), atol=2e-2)


def test_samples_match_jax_on_its_draws(fitted):
    """With JAX's normal draws passed in (``posterior_samples`` splits its
    key into the xi and eta keys; ``sample_posterior`` draws xi from its
    key), the port's samples equal JAX's within 1e-4 (f32 solves and
    products on the 12-mode cache)."""
    jm, jp, tm, tp, x, _ = fitted
    xq, num = x[:30], 64
    jm.eval(jp)
    tm.eval(tp)
    key = jax.random.PRNGKey(7)
    jsamp = np.asarray(jm.posterior_samples(jp, xq, key, num, noisy_posterior=True))
    _, k_xi, k_eta = jax.random.split(key, 3)
    xi = np.asarray(jax.random.normal(k_xi, (12, num), jnp.float32))
    eta = np.asarray(jax.random.normal(k_eta, (num, 30), jnp.float32))
    tsamp = tm.posterior_samples(tp, xq, None, num, noisy_posterior=True,
                                 xi=torch.from_numpy(xi.copy()), eta=torch.from_numpy(eta.copy()))
    np.testing.assert_allclose(tsamp.numpy(), jsamp, atol=1e-4)
    jpost = jm.posterior(jp, xq)
    dense_j = np.asarray(jax_sample_posterior(jpost, jax.random.PRNGKey(3), num))
    xi_d = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (30, num), jnp.float32))
    dense_t = sample_posterior(tm.posterior(tp, xq), None, num, xi=torch.from_numpy(xi_d.copy()))
    np.testing.assert_allclose(dense_t.numpy(), dense_j, atol=1e-4)


def test_grid_uniform_box():
    """Uniform draws in the box center ± (la, lb), from a generator or a
    passed-in draw."""
    pts = grid_uniform(torch.Generator().manual_seed(0), [1.0, -2.0], 0.5, 0.25, samples=500)
    assert tuple(pts.shape) == (500, 2)
    assert bool((pts[:, 0] >= 0.5).all() and (pts[:, 0] <= 1.5).all())
    assert bool((pts[:, 1] >= -2.25).all() and (pts[:, 1] <= -1.75).all())
    u = torch.tensor([[0.0, 1.0], [0.5, 0.5]])
    np.testing.assert_allclose(grid_uniform(None, [0.0, 0.0], 1.0, u=u).numpy(),
                               [[-1.0, 1.0], [0.0, 0.0]])


def _covar_problem():
    rng = np.random.default_rng(22)
    n = 300
    a = rng.standard_normal((n, 40)).astype(np.float32)
    covar = (a @ a.T / 40 + 0.05 * np.eye(n, dtype=np.float32)).astype(np.float32)
    err = rng.standard_normal(n).astype(np.float32)
    return covar, err


def test_stochastic_nll_converges_to_exact():
    """Twin of test_love.py::test_stochastic_nll_converges_to_exact: with
    rich settings the estimate is within 0.02 of the exact NLL, at the
    reference's defaults within 0.3."""
    covar, err = _covar_problem()
    c, e = torch.from_numpy(covar), torch.from_numpy(err)
    exact = float(gaussian_nll(e, c))
    rich = float(gaussian_nll_stochastic(e, c, torch.Generator().manual_seed(0),
                                         num_probes=128, lanczos_steps=80, cg_tol=1e-6,
                                         jitter=0.0))
    assert abs(rich - exact) < 0.02, (rich, exact)
    ref_like = float(gaussian_nll_stochastic(e, c, torch.Generator().manual_seed(1)))
    assert abs(ref_like - exact) < 0.3
    np.testing.assert_allclose(exact, float(jax_gaussian_nll(jnp.asarray(err),
                                                             jnp.asarray(covar))), rtol=1e-5)


def test_stochastic_nll_matches_jax_on_its_probes():
    """At the reference's defaults, with JAX's Rademacher probes passed in
    (``rademacher_probes(key, n, 10)``), the port's estimate equals JAX's
    within 1e-4 relative (CG to 1e-2 and 20 Lanczos steps in f32)."""
    covar, err = _covar_problem()
    key = jax.random.PRNGKey(4)
    jnll = float(jax_nll_stochastic(jnp.asarray(err), jnp.asarray(covar), key))
    probes = np.asarray(jax.random.rademacher(key, (300, 10), dtype=jnp.float32))
    tnll = float(gaussian_nll_stochastic(torch.from_numpy(err), torch.from_numpy(covar),
                                         probes=torch.from_numpy(probes.copy())))
    np.testing.assert_allclose(tnll, jnll, rtol=1e-4)


def test_test_model_reference_metric_matches_jax(fitted):
    """``test_model(metric="reference")`` on held-out points of the circle,
    the port on the probes JAX's key draws: RMSE and NLL within 1e-4
    relative; without a generator or probes the port refuses."""
    jm, jp, tm, tp, x, y = fitted
    xt = (x[::7] * 1.01).astype(np.float32)
    yt = y[::7]
    key = jax.random.PRNGKey(2)
    jr = jax_test_model(jm, jp, xt, yt, noisy_test=True, metric="reference", key=key)
    probes = np.asarray(jax.random.rademacher(key, (xt.shape[0], 10), dtype=jnp.float32))
    tr = torch_test_model(tm, tp, xt, yt, noisy_test=True, metric="reference",
                          probes=torch.from_numpy(probes.copy()))
    np.testing.assert_allclose(tr, jr, rtol=1e-4)
    with pytest.raises(ValueError, match="stochastic"):
        torch_test_model(tm, tp, xt, yt, metric="reference")
