"""Port vs JAX: the vanilla (Euclidean) GP baseline — ``kernels.euclidean``,
``models.VanillaGP`` in its dense and BBMM regimes, ``vanilla_train`` and
the hybrid blend ``RiemannGP.posterior(base_model=...)`` (twins of
tests/test_love.py's three vanilla tests and of
tests/test_models.py::test_vanilla_gp_end_to_end / ::test_hybrid_posterior_blend).

The same numpy inputs go through both packages on the CPU. The BBMM loss
shares its randomness: the mBCG probes are built from the same numpy
Rademacher draws in both packages (zm = L z1 + sqrt(d) z2 from each
package's own pivoted-Cholesky preconditioner, zr plain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from _semisup_pins import rademacher_numpy
from manifold_gp_tpu.kernels import euclidean as jeu
from manifold_gp_tpu.ops import pivchol as jpivchol
from manifold_gp_tpu.utils.evaluate import test_model as j_test_model
from manifold_gp_tpu.utils.train import vanilla_train as j_vanilla_train
from manifold_gp_torch.kernels import euclidean as teu
from manifold_gp_torch.utils import test_model as t_test_model
from manifold_gp_torch.utils import vanilla_train

RAW = ("raw_lengthscale", "raw_noise", "raw_outputscale", "mean_constant")
INIT = dict(noise=1e-2, outputscale=1.0, lengthscale=0.5)


def _circle(n, seed, step, shift):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    y = np.sin(3 * t).astype(np.float32)
    return x, y, (x[::step] + shift).astype(np.float32)


def _vanilla(x, y, kernel="rbf", **cfg_kw):
    jk, tk = ((jeu.RBFKernel(), teu.RBFKernel(device="cpu")) if kernel == "rbf"
              else (jeu.MaternKernel(kernel), teu.MaternKernel(kernel, device="cpu")))
    return (J.VanillaGP(x, jnp.asarray(y), jk, cfg=J.InferenceConfig(**cfg_kw)),
            T.VanillaGP(x, y, tk, cfg=T.InferenceConfig(**cfg_kw)))


@pytest.mark.parametrize("kind", ["rbf", 0.5, 1.5, 2.5])
def test_grams_match_jax(kind):
    """sq_dists by JAX's formula and every kernel's gram, 2e-6 of the
    largest entry; the tiled gram_matvec equals the dense product."""
    rng = np.random.default_rng(2)
    x1 = rng.standard_normal((300, 5)).astype(np.float32)
    x2 = rng.standard_normal((70, 5)).astype(np.float32)
    v = rng.standard_normal((70, 3)).astype(np.float32)
    np.testing.assert_allclose(teu.sq_dists(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
                               np.asarray(jeu.sq_dists(jnp.asarray(x1), jnp.asarray(x2))),
                               atol=2e-6 * 40)
    jm, tm = _vanilla(x1, x1[:, 0], kind)
    jp, tp = jm.kernel.init_params(lengthscale=0.8), tm.kernel.init_params(lengthscale=0.8)
    want = np.asarray(jm.kernel.gram(jp, jnp.asarray(x1), jnp.asarray(x2)))
    got = tm.kernel.gram(tp, torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    tiled = tm.kernel.gram_matvec(tp, torch.from_numpy(x1), torch.from_numpy(v),
                                  torch.from_numpy(x2), block_size=64)
    np.testing.assert_allclose(tiled.numpy(), got.numpy() @ v, atol=1e-5)
    np.testing.assert_allclose(
        tm.kernel.gram_matvec(tp, torch.from_numpy(x1), torch.from_numpy(v[:, 0]),
                              torch.from_numpy(x2)).numpy(), got.numpy() @ v[:, 0], atol=1e-5)


def test_matern_kernel_refuses_other_smoothness_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="half-integer"):
        teu.MaternKernel(2.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.RBFKernel()


def test_vanilla_iterative_eval_matches_dense():
    """Twin of test_love.py::test_vanilla_iterative_eval_matches_dense:
    above max_cholesky the posterior cache comes from pivoted-Cholesky CG
    (mean) and rank-n LOVE (variances), equal to the dense path (the JAX
    test's tolerances); both regimes equal JAX's on JAX's start vector."""
    x, y, xs = _circle(400, 7, 7, 0.03)
    n = x.shape[0]
    jd, td = _vanilla(x, y, max_cholesky=800)
    ji, ti = _vanilla(x, y, max_cholesky=0, cg_tolerance=1e-6, cg_max_iter=800)
    jp, tp = jd.init_params(**INIT), td.init_params(**INIT)
    post_d = td.eval(tp).posterior(tp, xs)
    assert "chol" in td._cache
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    ti.eval(tp, love_rank=n, love_v0=torch.from_numpy(v0))
    assert "love" in ti._cache
    post_i = ti.posterior(tp, xs)
    np.testing.assert_allclose(post_i.mean.numpy(), post_d.mean.numpy(), atol=1e-4)
    np.testing.assert_allclose(post_i.stddev.numpy(), post_d.stddev.numpy(), atol=1e-3)
    np.testing.assert_allclose(ti.posterior(tp, xs, noisy_posterior=True).covar.numpy(),
                               td.posterior(tp, xs, noisy_posterior=True).covar.numpy(),
                               atol=1e-3)
    jpost_d = jd.eval(jp).posterior(jp, xs)
    np.testing.assert_allclose(post_d.mean.numpy(), np.asarray(jpost_d.mean), atol=2e-5)
    np.testing.assert_allclose(post_d.covar.numpy(), np.asarray(jpost_d.covar), atol=2e-5)
    jpost_i = ji.eval(jp, love_rank=n).posterior(jp, xs)
    np.testing.assert_allclose(post_i.mean.numpy(), np.asarray(jpost_i.mean), atol=1e-4)
    np.testing.assert_allclose(post_i.stddev.numpy(), np.asarray(jpost_i.stddev), atol=1e-3)


def test_vanilla_iterative_eval_low_rank_underestimates():
    """Twin of test_love.py::test_vanilla_iterative_eval_low_rank_underestimates:
    rank-20 LOVE removes less than the exact solve, so its variances lie
    above the exact ones."""
    x, y, xs = _circle(300, 11, 5, 0.02)
    _, td = _vanilla(x, y, max_cholesky=800)
    _, ti = _vanilla(x, y, max_cholesky=0, cg_tolerance=1e-6, cg_max_iter=800)
    p = td.init_params(**INIT)
    var_exact = td.eval(p).posterior(p, xs).stddev.numpy() ** 2
    var_low = ti.eval(p, love_rank=20).posterior(p, xs).stddev.numpy() ** 2
    assert np.all(var_low >= var_exact - 1e-5)
    assert np.mean(var_low - var_exact) > 0


def _jax_probes(monkeypatch, z1, z2, zr):
    """Make the JAX package's pivoted-Cholesky preconditioner draw the given
    numpy arrays instead of its keyed Rademacher probes."""
    monkeypatch.setattr(jpivchol.LowRankDiagPrecond, "sample",
                        lambda self, key, p: (jnp.matmul(self.L, jnp.asarray(z1),
                                                         precision=jax.lax.Precision.HIGHEST)
                                              + jnp.sqrt(self.d)[:, None] * jnp.asarray(z2)))
    monkeypatch.setattr(jpivchol.LowRankDiagPrecond, "unit_sample",
                        lambda self, key, p: jnp.asarray(zr))


def _draws(n, rank, p, seed):
    return rademacher_numpy(seed, ((rank, p), (n, p), (n, p)))


def _port_probes(tm, tp, z1, z2, zr):
    """The port's (zm, zr) on the same draws: zm = L z1 + sqrt(d) z2 with
    the port's own preconditioner, what its ``sample`` draws."""
    with torch.no_grad():
        _, pobj = tm.pivchol_precond(tp)
        zm = pobj.L @ torch.from_numpy(z1) + torch.sqrt(pobj.d)[:, None] * torch.from_numpy(z2)
    return zm, torch.from_numpy(zr)


@pytest.mark.parametrize("regime", ["dense", "bbmm"])
def test_mll_loss_and_gradients_match_jax(regime, monkeypatch):
    """The dense Cholesky loss (n <= max_cholesky) and the BBMM loss (CG
    plus the mBCG log-det under rank-15 pivoted Cholesky, 16 shared probes,
    CG at 1e-6) with their gradients: loss 1e-4 relative, gradients 5e-3 of
    the largest."""
    x, y, _ = _circle(300, 4, 5, 0.0)
    kw = dict(max_cholesky=800) if regime == "dense" else dict(
        max_cholesky=0, num_probes=16, lanczos_max_iter=24, cg_tolerance=1e-6,
        cg_max_iter=800)
    jm, tm = _vanilla(x, y, **kw)
    init = dict(INIT, mean_constant=0.1)
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**init).items()}
    probes = None
    if regime == "bbmm":
        z1, z2, zr = _draws(300, 15, 16, seed=9)
        _jax_probes(monkeypatch, z1, z2, zr)
        probes = _port_probes(tm, tp, z1, z2, zr)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.mll_loss(p, key=jax.random.PRNGKey(0))))(
        jm.init_params(**init))
    tl = tm.mll_loss(tp, probes=probes)
    tg = torch.autograd.grad(tl, [tp[k] for k in RAW])
    jgv = np.array([float(jg[k]) for k in RAW])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose([float(g) for g in tg], jgv, atol=5e-3 * np.abs(jgv).max())
    if regime == "bbmm":
        with pytest.raises(ValueError, match="Generator"):
            tm.mll_loss(tp)
        a = tm.mll_loss(tp, generator=torch.Generator().manual_seed(1))
        assert np.isfinite(float(a)) and abs(float(a) - float(tl)) < 0.05 * abs(float(tl))


def test_vanilla_matrix_free_gram_matches_dense():
    """Twin of test_love.py::test_vanilla_matrix_free_gram_matches_dense:
    above dense_gram_max_size the BBMM loss (value and gradients, the same
    probes) and the posterior come from the tiled gram_matvec and match the
    gram-made-once path (the JAX test's tolerances)."""
    x, y, xs = _circle(500, 5, 11, 0.02)
    n = x.shape[0]

    def build(dense_gram):
        _, m = _vanilla(x, y, kernel=2.5, max_cholesky=0, cg_tolerance=1e-6, cg_max_iter=800,
                        num_probes=64, lanczos_max_iter=48, dense_gram_max_size=dense_gram)
        return m

    m_d, m_f = build(20000), build(0)
    out = {}
    for name, m in (("dense", m_d), ("tiled", m_f)):
        p = {k: v.requires_grad_(True) for k, v in m.init_params(**INIT).items()}
        loss = m.mll_loss(p, generator=torch.Generator().manual_seed(0))
        out[name] = (float(loss), [float(g) for g in torch.autograd.grad(
            loss, [p[k] for k in RAW[:3]])])
    np.testing.assert_allclose(out["tiled"][0], out["dense"][0], rtol=1e-4)
    np.testing.assert_allclose(out["tiled"][1], out["dense"][1], rtol=1e-2, atol=1e-5)
    p = m_d.init_params(**INIT)
    post_d = m_d.eval(p, love_rank=n).posterior(p, xs)
    post_f = m_f.eval(p, love_rank=n).posterior(p, xs)
    np.testing.assert_allclose(post_f.mean.numpy(), post_d.mean.numpy(), atol=1e-4)
    np.testing.assert_allclose(post_f.stddev.numpy(), post_d.stddev.numpy(), atol=1e-3)


def test_vanilla_gp_end_to_end():
    """Twin of test_models.py::test_vanilla_gp_end_to_end: 30 epochs of
    ``vanilla_train`` on the small circle (dense regime, no randomness),
    the trajectory held to JAX's (losses 1e-4; final raw hyperparameters
    5e-4, half a percent of one Adam step of lr = 0.1, since f32 Cholesky
    sums differ in the last bits and 30 Adam steps carry them on)
    and ``test_model``'s RMSE / NLL to JAX's (1e-4) and below 0.5."""
    x, y = small_cloud()
    jm, tm = _vanilla(x, y)
    tp, tloss, thist = vanilla_train(tm, tm.init_params(**INIT), lr=0.1, max_iter=30)
    jp, jloss, jhist = j_vanilla_train(jm, jm.init_params(**INIT), lr=0.1, max_iter=30)
    assert np.isfinite(tloss) and len(thist) == 31
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-4, atol=1e-5)
    for k in RAW:
        np.testing.assert_allclose(float(tp[k].detach()), float(jp[k]), atol=5e-4)
    rmse, nll = t_test_model(tm, tp, x, y, noisy_test=True)
    jrmse, jnll = j_test_model(jm, jp, x, y, noisy_test=True)
    assert rmse < 0.5
    np.testing.assert_allclose([rmse, nll], [jrmse, jnll], rtol=1e-4, atol=1e-5)


def test_hybrid_posterior_blend():
    """Twin of test_models.py::test_hybrid_posterior_blend: far from the
    manifold the blend is the vanilla posterior (the JAX test's 1e-4);
    on the manifold and off it the blended mean, covariance and stddev
    equal JAX's (2e-5); ``test_model(base_model=...)`` equals JAX's."""
    x, y = small_cloud()
    common = dict(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                  num_modes=20, bump_scale=10.0, bump_decay=1.0)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(max_cholesky=800), **common)
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(max_cholesky=800), device="cpu", **common)
    jmodel, tmodel = J.RiemannGP(x, jnp.asarray(y), jk), T.RiemannGP(x, y, tk)
    hyp = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=0.9)
    jp, tp = jmodel.init_params(**hyp), tmodel.init_params(**hyp)
    jv, tv = _vanilla(x, y)
    jvp, tvp = jv.init_params(**INIT), tv.init_params(**INIT)
    jmodel.eval(jp)
    tmodel.eval(tp)
    jv.eval(jvp)
    tv.eval(tvp)
    far = np.full((4, 2), 30.0, np.float32)
    post = tmodel.posterior(tp, far, noisy_posterior=True, base_model=tv, base_params=tvp)
    vpost = tv.posterior(tvp, far, noisy_posterior=True)
    np.testing.assert_allclose(post.mean.numpy(), vpost.mean.numpy(), rtol=1e-4, atol=1e-5)
    near = np.concatenate([x[::10] * 1.05, far]).astype(np.float32)
    post = tmodel.posterior(tp, near, noisy_posterior=True, base_model=tv, base_params=tvp)
    jpost = jmodel.posterior(jp, near, noisy_posterior=True, base_model=jv, base_params=jvp)
    for field in ("mean", "covar", "stddev"):
        want = np.asarray(getattr(jpost, field))
        np.testing.assert_allclose(getattr(post, field).numpy(), want,
                                   atol=2e-5 * np.abs(want).max())
    got = t_test_model(tmodel, tp, near, np.zeros(len(near), np.float32), noisy_test=True,
                       base_model=tv, base_params=tvp)
    want = j_test_model(jmodel, jp, near, np.zeros(len(near), np.float32), noisy_test=True,
                        base_model=jv, base_params=jvp)
    np.testing.assert_allclose(got, want, rtol=1e-4)
