"""Port vs JAX and dense oracles: the preconditioner family (pivoted
Cholesky, low-rank-plus-diagonal, deflation, the degree-conjugated wrap)
and the preconditioned (mBCG) SLQ log-det (twin of the single-device tests
of tests/test_mbcg.py).

Identities are held to dense numpy oracles at the JAX tests' tolerances;
parity with JAX runs on the same numpy inputs, with JAX's own probe draws
handed to the port. The ill-conditioned quadrature is held to an oracle
built from eigenvalues: the f64 dense Neumann matrix at condition ~1e10 is
no longer numerically positive definite, while its eigenvalues are the
Neumann polynomial of the symmetric Q's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_tpu.ops import pivchol as jpc
from manifold_gp_tpu.ops import slq as jslq
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap
from manifold_gp_torch.ops import matern as tmat
from manifold_gp_torch.ops import pivchol as tpc
from manifold_gp_torch.ops import slq as tslq
from manifold_gp_torch.ops.cg import cg_raw
from manifold_gp_torch.ops.operator import Operator

RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _circle(n, seed=0):
    t = np.sort(np.random.default_rng(seed).uniform(0, 2 * np.pi, n))
    return np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)


def _chain_problem(n, eps, nu=3, noise=1e-2):
    """A noisy randomwalk Matérn precision on a sorted circle sample (the
    JAX test's ``_chain_problem``), on the port's ELL path."""
    graph = tgraph.build_graph(_circle(n), 6, device="cpu")
    noise = torch.tensor(noise)

    def build(eps_):
        c = tlap.laplacian_coeffs(graph, eps_)
        mv = tmat.make_noisy_matvec(
            tmat.make_matern_precision_matvec(graph, c, nu, 1.0, "randomwalk"), noise)
        d = tmat.noisy_scaled_diag(
            tmat.matern_precision_diag(graph, c, nu, 1.0, "randomwalk"), noise=noise)
        return c, mv, d

    return graph, build


# -- the preconditioner objects against dense oracles ------------------------


def test_pivoted_cholesky_full_rank_reconstructs():
    n = 48
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T + n * np.eye(n, dtype=np.float32)
    ts = torch.from_numpy(spd)
    bigl, d_res = tpc.pivoted_cholesky(lambda v: ts @ v, torch.diagonal(ts), n)
    np.testing.assert_allclose(bigl.numpy() @ bigl.numpy().T, spd, atol=1e-2 * n)
    assert float(d_res.max()) < 1e-2 * n


def test_lowrank_diag_precond_identities():
    rng = np.random.default_rng(1)
    n, r = 60, 7
    bigl = rng.standard_normal((n, r)).astype(np.float32)
    d = (0.5 + rng.random(n)).astype(np.float32)
    m = bigl @ bigl.T + np.diag(d)
    c = np.eye(r, dtype=np.float32) + bigl.T @ (bigl / d[:, None])
    p = tpc.LowRankDiagPrecond(L=torch.from_numpy(bigl), d=torch.from_numpy(d),
                               chol_c=torch.linalg.cholesky(torch.from_numpy(c)))
    v = rng.standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_allclose(p.apply(torch.from_numpy(v)).numpy(), np.linalg.solve(m, v),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(p.apply(torch.from_numpy(v[:, 0])).numpy(),
                               np.linalg.solve(m, v[:, 0]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(p.logdet()), np.linalg.slogdet(m.astype(np.float64))[1],
                               rtol=1e-5)
    # E[z z'] = M: the sample second moment converges (6,000 probes)
    z = p.sample(_gen(0), 6000).numpy()
    assert np.linalg.norm(z @ z.T / z.shape[1] - m) / np.linalg.norm(m) < 0.1
    zu = p.unit_sample(_gen(1), 16).numpy()
    assert zu.shape == (n, 16) and set(np.unique(zu)) == {-1.0, 1.0}


def test_diag_precond_logdet_and_samples():
    d = np.linspace(0.5, 4.0, 40).astype(np.float32)
    p = tpc.DiagPrecond(d=torch.from_numpy(d))
    np.testing.assert_allclose(float(p.logdet()), np.sum(np.log(d.astype(np.float64))), rtol=1e-6)
    z = p.sample(_gen(2), 8)
    np.testing.assert_allclose(z.abs().numpy(), np.sqrt(d)[:, None] * np.ones((1, 8)), rtol=1e-6)
    # the same generator state gives the same draw, and unit samples are +-1
    assert torch.equal(p.unit_sample(_gen(3), 5), p.unit_sample(_gen(3), 5))
    assert set(np.unique(p.unit_sample(_gen(3), 5).numpy())) == {-1.0, 1.0}


def _deflation_case(seed, n=50, m_modes=6, q_hi=30.0):
    rng = np.random.default_rng(seed)
    v_full, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float32))
    v = v_full[:, :m_modes].astype(np.float32)
    return rng, v, np.linspace(0.1, q_hi, n).astype(np.float32)[:m_modes]


def test_deflation_precond_identities():
    rng, v, q = _deflation_case(2)
    n, tau = v.shape[0], 3.0
    m_mat = v @ np.diag(q) @ v.T + tau * (np.eye(n) - v @ v.T)
    p = tpc.make_deflation_precond(torch.from_numpy(v), torch.from_numpy(q), tau)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    np.testing.assert_allclose(p.apply(torch.from_numpy(x)).numpy(), np.linalg.solve(m_mat, x),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(p.logdet()),
                               np.linalg.slogdet(m_mat.astype(np.float64))[1], rtol=1e-5)
    z = p.sample(_gen(1), 6000).numpy()
    assert np.linalg.norm(z @ z.T / z.shape[1] - m_mat) / np.linalg.norm(m_mat) < 0.1


def test_conjugated_precond_identities():
    rng, v, _ = _deflation_case(3)
    n = v.shape[0]
    q = np.linspace(0.5, 20.0, v.shape[1]).astype(np.float32)
    tau = 2.5
    d = (0.5 + rng.random(n)).astype(np.float32)
    inner = tpc.make_deflation_precond(torch.from_numpy(v), torch.from_numpy(q), tau)
    p = tpc.ConjugatedPrecond(d=torch.from_numpy(d), inner=inner)
    m_inner = v @ np.diag(q) @ v.T + tau * (np.eye(n) - v @ v.T)
    m_mat = np.diag(d) @ m_inner @ np.diag(d)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    np.testing.assert_allclose(p.apply(torch.from_numpy(x)).numpy(), np.linalg.solve(m_mat, x),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(float(p.logdet()),
                               np.linalg.slogdet(m_mat.astype(np.float64))[1], rtol=1e-5)
    z = p.sample(_gen(1), 8000).numpy()
    assert np.linalg.norm(z @ z.T / z.shape[1] - m_mat) / np.linalg.norm(m_mat) < 0.12


def test_masked_preconditioners_raise_for_the_multi_gpu_path():
    """The masked (padded row space) preconditioners of the multi-GPU path,
    ported since the mesh path: on one device they equal JAX's masked
    classes on the same inputs (apply, logdet), act as the identity off the
    support, and sample on the support only. The pivoted Cholesky never
    pivots on a padding row."""
    rng = np.random.default_rng(21)
    n, m = 40, 5
    mask = np.ones(n, np.float32)
    mask[[3, 17, 29, 38, 39]] = 0.0
    a = rng.standard_normal((n, 12)).astype(np.float32)
    dense = (a @ a.T + np.diag(np.linspace(1.0, 9.0, n))).astype(np.float32)
    dense = dense * mask[:, None] * mask[None, :]
    d = np.where(mask > 0, np.diagonal(dense), 1.0).astype(np.float32)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    v, _ = np.linalg.qr(rng.standard_normal((n, m)) * mask[:, None])
    v = (v * mask[:, None]).astype(np.float32)
    q = np.linspace(0.5, 3.0, m).astype(np.float32)

    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    tdiag, jdiag = tpc.MaskedDiagPrecond(d=torch.from_numpy(d), mask=tm), \
        jpc.MaskedDiagPrecond(d=jnp.asarray(d), mask=jm)
    tdef = tpc.make_deflation_precond(torch.from_numpy(v), torch.from_numpy(q), 2.0, mask=tm)
    jdef = jpc.make_deflation_precond(jnp.asarray(v), jnp.asarray(q), 2.0, mask=jm)
    assert isinstance(tdef, tpc.MaskedDeflationPrecond)
    top = Operator(lambda u: torch.from_numpy(dense) @ u)
    tpiv = tpc.make_pivchol_precond_masked(top, torch.from_numpy(d), tm, 6)
    jpiv = jpc.make_pivchol_precond_masked(lambda u: jnp.asarray(dense) @ u, jnp.asarray(d),
                                           jm, 6)
    assert float(torch.abs(tpiv.L[mask == 0]).max()) == 0.0
    for tp, jp in ((tdiag, jdiag), (tdef, jdef), (tpiv, jpiv)):
        np.testing.assert_allclose(tp.apply(torch.from_numpy(x)).numpy(),
                                   np.asarray(jp.apply(jnp.asarray(x))), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tp.logdet()), float(jp.logdet()), rtol=1e-5)
        off = tp.apply(torch.from_numpy(x)).numpy()[mask == 0]
        if tp is not tpiv:
            np.testing.assert_array_equal(off, x[mask == 0])
        for z in (tp.sample(_gen(3), 4), tp.unit_sample(_gen(4), 4)):
            assert float(torch.abs(z[torch.from_numpy(mask == 0)]).max()) == 0.0


def test_pivchol_invariant_and_no_graph():
    """M = L L' + diag(d) is applied exactly (M^{-1} M x = x) and the build
    keeps no autograd graph even when the operator's tensors need one."""
    rng = np.random.default_rng(4)
    n = 120
    a = rng.standard_normal((n, 30)).astype(np.float32)
    s = torch.from_numpy(a @ a.T + np.diag(np.linspace(1.0, 50.0, n)).astype(np.float32))
    theta = torch.tensor(1.5, requires_grad=True)
    op = Operator(lambda v, th: th * (s @ v), (theta,))
    with torch.enable_grad():
        p = tpc.make_pivchol_precond(op, theta.detach() * torch.diagonal(s), 15)
    assert not any(t.requires_grad for t in (p.L, p.d, p.chol_c))
    x = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    mx = p.L @ (p.L.T @ x) + p.d[:, None] * x
    assert float(torch.linalg.norm(p.apply(mx) - x) / torch.linalg.norm(x)) <= 1e-4


# -- parity with JAX ----------------------------------------------------------


def _separated_spd(n, seed=5):
    """An SPD matrix whose diagonal values lie far apart, so the greedy
    pivots of two f32 implementations cannot swap on a near tie."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n // 2)).astype(np.float32) / np.sqrt(n)
    return (a @ a.T + np.diag(np.linspace(1.0, 40.0, n) ** 1.5)).astype(np.float32)


def test_pivoted_cholesky_matches_jax():
    n, rank = 90, 15
    a = _separated_spd(n)
    jl, jd = jpc.pivoted_cholesky(lambda v: jnp.asarray(a) @ v, jnp.diagonal(jnp.asarray(a)), rank)
    ta = torch.from_numpy(a)
    tl, td = tpc.pivoted_cholesky(lambda v: ta @ v, torch.diagonal(ta), rank)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5 * scale)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5 * scale)
    jp = jpc.make_pivchol_precond(lambda v: jnp.asarray(a) @ v, jnp.diagonal(jnp.asarray(a)), rank)
    tp = tpc.make_pivchol_precond(lambda v: ta @ v, torch.diagonal(ta), rank)
    np.testing.assert_allclose(tp.d.numpy(), np.asarray(jp.d), rtol=1e-5)
    np.testing.assert_allclose(float(tp.logdet()), float(jp.logdet()), rtol=1e-5)


def _jax_precond(kind, a):
    n = a.shape[0]
    ja = jnp.asarray(a)
    if kind == "diag":
        return jpc.DiagPrecond(d=jnp.diagonal(ja))
    if kind == "pivchol":
        return jpc.make_pivchol_precond(lambda v: ja @ v, jnp.diagonal(ja), 10)
    evals, evecs = np.linalg.eigh(a.astype(np.float64))
    return jpc.make_deflation_precond(jnp.asarray(evecs[:, :8].astype(np.float32)),
                                      jnp.asarray(evals[:8].astype(np.float32)),
                                      float(np.sqrt(evals[8] * evals[-1])))


def _port_precond(jp):
    """The same preconditioner as a port object, from JAX's arrays."""
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    if isinstance(jp, jpc.DiagPrecond):
        return tpc.DiagPrecond(d=t(jp.d))
    if isinstance(jp, jpc.LowRankDiagPrecond):
        return tpc.LowRankDiagPrecond(L=t(jp.L), d=t(jp.d), chol_c=t(jp.chol_c))
    return tpc.DeflationPrecond(v=t(jp.v), q=t(jp.q), tau=t(jp.tau))


@pytest.mark.parametrize("kind", ["diag", "pivchol", "deflation"])
def test_slq_logdet_mbcg_matches_jax_with_its_probes(kind):
    n, p, steps = 150, 16, 25
    a = _separated_spd(n, seed=6)
    jp = _jax_precond(kind, a)
    key = jax.random.PRNGKey(3)
    k_m, k_r = jax.random.split(key)
    zm, zr = np.array(jp.sample(k_m, p)), np.array(jp.unit_sample(k_r, p))

    def jf(theta):
        return jslq.slq_logdet_mbcg(lambda v: jnp.asarray(a) @ v + theta * v, jp, key, p, steps,
                                    cg_tol=1e-6, cg_max_iter=500)

    jval, jgrad = jax.value_and_grad(jf)(jnp.float32(0.4))
    ta = torch.from_numpy(a)
    theta = torch.tensor(0.4, requires_grad=True)
    op = Operator(lambda v, th: ta @ v + th * v, (theta,))
    tval = tslq.slq_logdet_mbcg(op, _port_precond(jp), None, None, steps, cg_tol=1e-6,
                                cg_max_iter=500,
                                probes=(torch.from_numpy(zm), torch.from_numpy(zr)))
    (tgrad,) = torch.autograd.grad(tval, theta)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-4)
    np.testing.assert_allclose(float(tgrad), float(jgrad), rtol=1e-3)


def test_pcg_tridiag_matches_jax_through_a_breakdown():
    """Coefficients of the fixed-step PCG, including a column whose Krylov
    space is exhausted after one step (a one-hot start on a decoupled row
    with diagonal 2: its residual is exactly zero) and is masked after it."""
    n, p, steps = 40, 4, 12
    a = _separated_spd(n, seed=7)
    a[0, :] = a[:, 0] = 0.0
    a[0, 0] = 2.0
    b = np.random.default_rng(8).standard_normal((n, p)).astype(np.float32)
    b[:, 3] = 0.0
    b[0, 3] = 1.0
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    out_j = jslq.pcg_tridiag_batched(lambda v: ja @ v, lambda v: v, jb, steps)
    ta = torch.from_numpy(a)
    out_t = tslq.pcg_tridiag_batched(lambda v: ta @ v, lambda v: v, torch.from_numpy(b), steps)
    assert np.array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert not out_t[2][-1, 3]
    live = np.asarray(out_j[2])
    for got, want in zip(out_t[:2], out_j[:2]):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=2e-3)
    fn = lambda lam: jnp.log(jnp.maximum(lam, 1e-20))  # noqa: E731
    quad_j = jslq._pcg_t_quadrature(*out_j, fn)
    quad_t = tslq._pcg_t_quadrature(*out_t, lambda lam: torch.log(torch.clamp(lam, min=1e-20)))
    np.testing.assert_allclose(quad_t.numpy(), np.asarray(quad_j), rtol=1e-4)


def _models(n=400, seed=3, **cfg_kw):
    """The same supervised problem as a JAX and a port model (dense
    operator path, SLQ branch)."""
    from examples_torch.run_large import torus_points

    x, u, _ = torus_points(n, seed=seed)
    y = (np.sin(2 * u) + 0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    kw = dict(max_cholesky=0, num_probes=8, lanczos_max_iter=12, cg_tolerance=1e-6,
              cg_max_iter=400)
    kw.update(cfg_kw)
    common = dict(nu=2, x=x, nearest_neighbors=10, laplacian_normalization="randomwalk",
                  num_modes=20)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(**kw), **common)
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(**kw), device="cpu", **common)
    return (J.RiemannGP(x, jnp.asarray(y), jk, cfg=J.InferenceConfig(**kw)),
            T.RiemannGP(x, y, tk, cfg=T.InferenceConfig(**kw)))


INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.15, lengthscale=1.0)


def _torch_loss_and_grads(tm, probes, precond_override=None):
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**INIT).items()}
    tl = tm.mll_loss(tp, probes=probes, precond_override=precond_override)
    tg = torch.autograd.grad(tl, [tp[k] for k in RAW])
    return float(tl.detach()), np.array([float(g) for g in tg])


def _jax_loss_and_grads(jm, key):
    jl, jg = jax.value_and_grad(lambda p: jm.mll_loss(p, key=key))(jm.init_params(**INIT))
    return float(jl), np.array([float(jg[k]) for k in RAW])


def test_mll_loss_with_pivchol_matches_jax(monkeypatch):
    """precond_type="pivchol": the preconditioner enters only the gradient's
    CG solves, so with shared probes both losses and gradients agree at the
    training twins' tolerances whatever pivots each side picks."""
    from manifold_gp_tpu.ops import engine as jengine

    jm, tm = _models(precond_type="pivchol")
    p = tm.init_params(**INIT)
    assert isinstance(tm.build_precond(p), tpc.LowRankDiagPrecond)
    assert isinstance(tm.precision_precond_obj(p), tpc.DiagPrecond)  # no matvec: Jacobi
    probes = (2 * np.random.default_rng(0).integers(0, 2, (400, 8)) - 1).astype(np.float32)
    monkeypatch.setattr(jengine, "rademacher_probes", lambda key, n_, p_: jnp.asarray(probes))
    jl, jg = _jax_loss_and_grads(jm, jax.random.PRNGKey(0))
    tl, tg = _torch_loss_and_grads(tm, torch.from_numpy(probes))
    np.testing.assert_allclose(tl, jl, rtol=5e-5)
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())


@pytest.mark.parametrize("precond_type", ["jacobi", "pivchol"])
def test_mll_loss_mbcg_matches_jax_with_its_probes(precond_type):
    """slq_precond_quadrature=True: the mBCG branch, with JAX's own zm / zr
    (drawn from JAX's preconditioner) handed to the port."""
    jm, tm = _models(precond_type=precond_type, slq_precond_quadrature=True)
    key = jax.random.PRNGKey(1)
    jl, jg = _jax_loss_and_grads(jm, key)
    jpar = jm.init_params(**INIT)
    c = jm.kernel.coeffs(jpar)
    jobj = jm.precision_precond_obj(jpar, coeffs=c, matvec=jm.precision_matvec(jpar, coeffs=c))
    k_m, k_r = jax.random.split(key)
    zm, zr = (torch.from_numpy(np.array(z)) for z in
              (jobj.sample(k_m, 8), jobj.unit_sample(k_r, 8)))
    tobj = tm.build_precond(tm.init_params(**INIT))
    if precond_type == "pivchol":
        assert isinstance(tobj, tpc.LowRankDiagPrecond)
        np.testing.assert_allclose(tobj.L.numpy(), np.asarray(jobj.L),
                                   atol=1e-5 * float(np.abs(np.asarray(jobj.L)).max()))
    tl, tg = _torch_loss_and_grads(tm, (zm, zr))
    np.testing.assert_allclose(tl, jl, rtol=5e-5)
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())
    # probes drawn from a generator instead: finite, and within MC spread
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**INIT).items()}
    drawn = tm.mll_loss(tp, generator=_gen(9))
    drawn = float(drawn.detach())
    assert np.isfinite(drawn) and abs(drawn - jl) < 0.05 * abs(jl) + 0.05
    with pytest.raises(ValueError, match="Generator"):
        tm.mll_loss(tp)


def test_deflation_precond_matches_jax():
    jm, tm = _models(n=300)
    jpar, tpar = jm.init_params(**INIT), tm.init_params(**INIT)
    jbasis = jm.kernel.eval_basis(jpar)
    tbasis = tuple(torch.from_numpy(np.array(b)) for b in jbasis)
    jobj = jm.deflation_precond(jpar, basis=jbasis)
    tobj = tm.deflation_precond(tpar, basis=tbasis)
    assert isinstance(tobj, tpc.ConjugatedPrecond)
    x = np.random.default_rng(4).standard_normal((300, 3)).astype(np.float32)
    want = np.asarray(jobj.apply(jnp.asarray(x)))
    np.testing.assert_allclose(tobj.apply(torch.from_numpy(x)).numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(tobj.logdet()), float(jobj.logdet()), rtol=1e-5)
    np.testing.assert_allclose(float(tobj.inner.tau), float(jobj.inner.tau), rtol=1e-5)


# -- the quadrature and the preconditioners at work ---------------------------


def test_mbcg_matches_dense_well_conditioned():
    """Value and gradient of the preconditioned quadrature against a dense
    f64 oracle on a well-conditioned chain."""
    n = 500
    _, build = _chain_problem(n, eps=0.3, nu=2)

    eps = torch.tensor(0.3, requires_grad=True)
    _, mv, _ = build(eps)
    dense = mv(torch.eye(n)).double()
    dense = 0.5 * (dense + dense.T)
    ld_ref = 2.0 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(dense))))
    (g_ref,) = torch.autograd.grad(ld_ref, eps)

    eps2 = torch.tensor(0.3, requires_grad=True)
    _, mv2, d2 = build(eps2)
    ld_m = tslq.slq_logdet_mbcg(mv2, tpc.DiagPrecond(d=d2.detach()), _gen(7), 64, 96,
                                cg_tol=1e-4, cg_max_iter=600)
    (g_m,) = torch.autograd.grad(ld_m, eps2)
    np.testing.assert_allclose(float(ld_m.detach()), float(ld_ref.detach()), rtol=2e-2)
    np.testing.assert_allclose(float(g_m), float(g_ref), rtol=5e-2)


def test_mbcg_quadrature_survives_ill_conditioning():
    """Small-eps / nu = 3 chain, the Neumann-wrapped operator's eigenvalues
    spanning ~1e23: the plain quadrature breaks down (NaN, or no closer than
    mBCG), the preconditioned one stays finite and near the oracle, and the
    port's estimate is JAX's on JAX's probes.

    The oracle: eigenvalues of the symmetric Q = D^{1/2} (shift + L)^3 D^{1/2}
    in f64, pushed through the 3-term Neumann polynomial, logged one by one.
    Against it the mBCG estimate at 96 steps is 5.0-5.2 % high in both
    packages (six JAX keys, three port generators) and 5.0 % in f64 dense
    arithmetic: the bias of 96 Jacobi-PCG steps at this conditioning (200
    steps: 4.5 %, 400: 4.1 %), not a rounding effect. So the bound here is
    6 %, and the parity with JAX carries the check of the port's numbers."""
    from manifold_gp_tpu.ops import graph as jgraph
    from manifold_gp_tpu.ops import laplacian as jlap
    from manifold_gp_tpu.ops import matern as jmat

    n, s2 = 800, 1e-2
    graph, build = _chain_problem(n, eps=0.02, nu=3)
    c, mv, d = build(0.02)
    rows, cols = graph.rows.numpy(), graph.cols.numpy()
    a = np.zeros((n, n))
    np.add.at(a, (rows, cols), c.triu.numpy().astype(np.float64))
    np.add.at(a, (cols, rows), c.triu.numpy().astype(np.float64))
    b = 2.0 * 3 * np.eye(n) + np.diag(c.diag.numpy().astype(np.float64)) - a
    d12 = np.sqrt(c.deg.numpy().astype(np.float64))
    q = d12[:, None] * (b @ b @ b) * d12[None, :]
    lam = np.linalg.eigvalsh(0.5 * (q + q.T))
    neumann = lam - s2 * lam**2 + s2**2 * lam**3
    assert neumann.min() > 0 and neumann.max() / neumann.min() > 1e8
    ld_exact = float(np.sum(np.log(neumann)))

    # JAX's estimate on the same chain, and its probes
    jg = jgraph.build_graph(_circle(n), 6)
    jc = jlap.laplacian_coeffs(jg, 0.02)
    jmv = jmat.make_noisy_matvec(jmat.make_matern_precision_matvec(jg, jc, 3, 1.0, "randomwalk"),
                                 1e-2)
    jp = jpc.DiagPrecond(d=jmat.noisy_scaled_diag(
        jmat.matern_precision_diag(jg, jc, 3, 1.0, "randomwalk"), noise=1e-2))
    key = jax.random.PRNGKey(5)
    k_m, k_r = jax.random.split(key)
    zm, zr = (torch.from_numpy(np.array(z)) for z in (jp.sample(k_m, 64), jp.unit_sample(k_r, 64)))
    ld_j = float(jslq.slq_logdet_mbcg(jmv, jp, key, 64, 96))

    z = tslq.rademacher_probes(_gen(5), n, 64)
    ld_plain = float(tslq.slq_logdet(mv, z, 96, cg_tol=1e-2, cg_max_iter=1000))
    ld_m = float(tslq.slq_logdet_mbcg(mv, tpc.DiagPrecond(d=d), None, None, 96, probes=(zm, zr)))
    np.testing.assert_allclose(ld_m, ld_j, rtol=1e-3)
    rel_m = abs(ld_m - ld_exact) / abs(ld_exact)
    assert np.isfinite(ld_m) and rel_m < 0.06, (ld_m, ld_exact)
    assert (not np.isfinite(ld_plain)) or abs(ld_plain - ld_exact) / abs(ld_exact) > rel_m, (
        ld_plain, ld_m, ld_exact)


def test_pivchol_precond_on_covariance_operator():
    """A covariance K = Z Z' + sigma^2 I with a fast-decaying spectrum: the
    rank-15 pivoted Cholesky cuts CG iterations below half of Jacobi's (inert
    here: the diagonal is nearly uniform)."""
    rng = np.random.default_rng(6)
    n, m = 600, 30
    z = rng.standard_normal((n, m)).astype(np.float32)
    z *= (2.0 ** -np.arange(m, dtype=np.float32))[None, :]
    khat = torch.from_numpy(z @ z.T + 1e-1 * np.eye(n, dtype=np.float32))
    mv = lambda v: khat @ v  # noqa: E731
    d0 = torch.diagonal(khat)
    b = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    _, it_jac = cg_raw(mv, b, 1e-6, 1000, precond=tpc.DiagPrecond(d=d0).apply, with_info=True)
    _, it_piv = cg_raw(mv, b, 1e-6, 1000, precond=tpc.make_pivchol_precond(mv, d0, 15).apply,
                       with_info=True)
    assert it_piv < 0.5 * it_jac, (it_piv, it_jac)


def test_randomwalk_deflation_reduces_cg_iterations():
    """On a randomwalk nu = 3 model the degree-conjugated approximate
    deflation cuts CG iterations below both no preconditioner and Jacobi,
    and reaches the same solution."""
    rng = np.random.default_rng(7)
    n, nu = 800, 3
    t = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    x = (np.stack([np.cos(t), np.sin(t)], 1)
         + 0.002 * rng.standard_normal((n, 2))).astype(np.float32)
    cfg = T.InferenceConfig(max_cholesky=0, cg_tolerance=1e-6, cg_max_iter=2000,
                            eigh_max_size=8192)
    kernel = T.RiemannMaternKernel(nu=nu, x=x, nearest_neighbors=6,
                                   laplacian_normalization="randomwalk", num_modes=100, cfg=cfg,
                                   device="cpu")
    model = T.RiemannGP(x, np.sin(3 * t).astype(np.float32), kernel, cfg=cfg)
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=0.5, lengthscale=10.0)
    mv = model.precision_matvec(params)
    b = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))

    def iters(precond, max_iter=400):
        _, it = cg_raw(mv, b, tol=1e-6, max_iter=max_iter,
                       precond=None if precond is None else precond.apply, with_info=True)
        return it

    # plain and Jacobi CG take well over 400 iterations here (2,000 do not
    # converge them); deflation converges far inside that cap
    defl = model.deflation_precond(params)
    it_none, it_jac, it_defl = iters(None), iters(model.precision_precond_obj(params)), iters(defl)
    assert it_defl < it_none and it_defl < it_jac, (it_defl, it_none, it_jac)
    # the deflated solve reaches the dense f64 solution (to the f32 forward
    # error: cond ~1e6 x 1e-8 residual)
    dense = mv(torch.eye(n)).double()
    s0 = np.linalg.solve(0.5 * (dense + dense.T).numpy(), b.double().numpy())
    sd = cg_raw(mv, b, tol=1e-8, max_iter=4000, precond=defl.apply).double().numpy()
    assert np.linalg.norm(sd - s0) / np.linalg.norm(s0) < 3e-2


def test_training_rebuilds_pivchol_and_runs_mbcg():
    """manifold_informed_train with precond_refresh: every rebuild is a
    LowRankDiagPrecond handed to the loss, and with the mBCG quadrature on
    the loss draws its probe pair from the training generator."""
    from manifold_gp_torch.utils import manifold_informed_train

    _, tm = _models(n=300, precond_type="pivchol", slq_precond_quadrature=True)
    built, seen = [], []
    build, loss = tm.build_precond, tm.mll_loss

    def record_build(p):
        built.append(build(p))
        return built[-1]

    def record_loss(p, **kw):
        seen.append(kw["precond_override"])
        return loss(p, **kw)

    tm.build_precond, tm.mll_loss = record_build, record_loss
    _, final, history = manifold_informed_train(tm, tm.init_params(**INIT), max_iter=3,
                                                num_rand_vec=50, precond_refresh=2)
    assert len(built) == 2 and all(isinstance(b, tpc.LowRankDiagPrecond) for b in built)
    assert seen == [built[0], built[0], built[1], built[1]]
    assert len(history) == 4 and np.all(np.isfinite(history)) and history[-1] < history[0]
