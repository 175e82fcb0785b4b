"""Port vs JAX: the semisupervised Schur path — ``labeled_split``,
``make_schur_matvec`` (the masked nested CG behind its index boundary),
and ``RiemannGP(labeled=...)``'s loss,
gradients, preconditioning and training (twins of
tests/test_precision.py::test_schur_complement / ::test_schur_gradient_flows,
tests/test_models.py::test_semisupervised_schur_training, a small case of
tests/test_schur_medium.py and the model case of
tests/test_precondition.py::test_model_loss_same_with_precondition).

The same numpy inputs go through both packages on the CPU. A Schur apply
runs a CG to its tolerance inside, so at the tight tolerances used here the
two packages differ by f32 sum order and by where each inner CG stops. The
port has one Schur complement, the masked form: the operator tests hold it
(through ``make_schur_matvec``) to JAX's index form. The forced-block case
(``dense_operator_max_size=0, use_dia=False``) runs it in padded-RCM space
on the plain kernel versions and holds its gradients to JAX's: it catches a
gradient lost through the inner solve. On block-ELL and DIA layouts the
model's permuted stack equals the node-order composition
(``make_schur_matvec`` over the unpermuted operator) on the same kernel;
both gather only at their boundary, the model's once around its whole stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _dense_oracles import (
    dense_graph_laplacian,
    dense_matern_precision,
    dense_noisy,
    dense_scaled,
    dense_schur_labeled,
)
from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_tpu.ops import engine as jengine
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_tpu.ops import matern as jmat
from manifold_gp_torch.ops import block_sparse, cg, dia
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap
from manifold_gp_torch.ops import matern as tmat
from manifold_gp_torch.ops.operator import Operator
from manifold_gp_torch.utils import manifold_informed_train, metrics

EPS = 0.35
NU = 2
LS = 1.3
RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")


@pytest.fixture(scope="module")
def graphs():
    x, _ = small_cloud()
    return jgraph.build_graph(x, 6), tgraph.build_graph(x, 6, device="cpu")


def _dense_prec(graph):
    lap, _, _, _, deg = dense_graph_laplacian(
        np.asarray(graph.rows), np.asarray(graph.cols), np.asarray(graph.sqdist), EPS,
        graph.num_nodes, normalization="randomwalk")
    return dense_matern_precision(lap, NU, LS, degree=deg)


def _rademacher(n, p, seed=0):
    return (2 * np.random.default_rng(seed).integers(0, 2, (n, p)) - 1).astype(np.float32)


def test_labeled_split_and_masked_schur_raises(graphs):
    """``labeled_split`` as JAX's; the masked Schur complement (the
    multi-GPU path's form, ported since the mesh path) equals the
    index-compacted one at the labeled rows, is zero elsewhere, and matches
    JAX's masked form on the same inputs."""
    mask = np.array([True, False, False, True, False])
    li, ui = tmat.labeled_split(mask)
    jli, jui = jmat.labeled_split(mask)
    assert li.tolist() == jli.tolist() == [0, 3] and ui.tolist() == jui.tolist() == [1, 2, 4]
    jg, tg = graphs
    n = tg.num_nodes
    labeled = np.zeros(n, bool)
    labeled[np.random.default_rng(13).choice(n, 12, replace=False)] = True
    li, ui = tmat.labeled_split(labeled)
    ml, mu = labeled.astype(np.float32), (~labeled).astype(np.float32)
    base = tmat.make_matern_precision_matvec(tg, tlap.laplacian_coeffs(tg, EPS), NU, LS,
                                             "randomwalk")
    masked = tmat.make_schur_matvec_masked(base, torch.from_numpy(ml), torch.from_numpy(mu),
                                           cg_tol=1e-8, cg_max_iter=2000)
    compact = tmat.make_schur_matvec(base, li, ui, n, cg_tol=1e-8, cg_max_iter=2000)
    assert all(a is b for a, b in zip(masked.consts, base.consts))
    v = np.random.default_rng(14).standard_normal((12, 3)).astype(np.float32)
    full = np.zeros((n, 3), np.float32)
    full[li] = v
    got = masked(torch.from_numpy(full)).numpy()
    want = compact(torch.from_numpy(v)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got[li] - want).max() <= 1e-5 * scale
    assert np.all(got[ui] == 0.0)
    jbase = jmat.make_matern_precision_matvec(jg, jlap.laplacian_coeffs(jg, EPS), NU, LS,
                                              "randomwalk")
    jmv = jmat.make_schur_matvec_masked(jbase, jnp.asarray(ml), jnp.asarray(mu), cg_tol=1e-8,
                                        cg_max_iter=2000)
    assert np.abs(got - np.asarray(jmv(jnp.asarray(full)))).max() <= 1e-5 * scale


def test_schur_complement(graphs):
    """Twin of test_precision.py::test_schur_complement: the nested-CG
    Schur apply against the dense oracle (the JAX test's tolerance) and
    against JAX's apply (1e-5 of the output scale: both inner CGs run to
    1e-8, beyond f32, so both stop at their last useful digit)."""
    jg, tg = graphs
    n = tg.num_nodes
    rng = np.random.default_rng(12)
    labeled = np.zeros(n, bool)
    labeled[rng.choice(n, 12, replace=False)] = True
    li, ui = tmat.labeled_split(labeled)
    base = tmat.make_matern_precision_matvec(tg, tlap.laplacian_coeffs(tg, EPS), NU, LS,
                                             "randomwalk")
    mv = tmat.make_schur_matvec(base, li, ui, n, cg_tol=1e-8, cg_max_iter=2000)
    assert isinstance(mv, Operator) and len(mv.consts) == len(base.consts)
    assert all(a is b for a, b in zip(mv.consts, base.consts))
    jbase = jmat.make_matern_precision_matvec(jg, jlap.laplacian_coeffs(jg, EPS), NU, LS,
                                              "randomwalk")
    jmv = jmat.make_schur_matvec(jbase, li, ui, n, cg_tol=1e-8, cg_max_iter=2000)
    v = rng.standard_normal((12, 2)).astype(np.float32)
    got = mv(torch.from_numpy(v)).numpy()
    dense = dense_schur_labeled(_dense_prec(tg), labeled)
    np.testing.assert_allclose(got, dense @ v, rtol=1e-3, atol=1e-3)
    want = np.asarray(jmv(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # [N] in, [N] out; and with the inner Jacobi preconditioner the same
    np.testing.assert_allclose(mv(torch.from_numpy(v[:, 0])).numpy(), got[:, 0],
                               atol=1e-5 * np.abs(want).max())
    pd = tmat.matern_precision_diag(tg, tlap.laplacian_coeffs(tg, EPS), NU, LS, "randomwalk")
    pmv = tmat.make_schur_matvec(base, li, ui, n, cg_tol=1e-8, cg_max_iter=2000, precond_diag=pd)
    np.testing.assert_allclose(pmv(torch.from_numpy(v)).numpy(), got,
                               atol=1e-5 * np.abs(want).max())


def test_schur_gradient_flows(graphs):
    """Twin of test_precision.py::test_schur_gradient_flows: the inner CG's
    implicit backward carries d/d(lengthscale) (and d/d(bandwidth)) of
    v' S v; held to central differences (the JAX test's 5e-2) and to JAX's
    gradient (1e-3)."""
    jg, tg = graphs
    n = tg.num_nodes
    labeled = np.zeros(n, bool)
    labeled[:8] = True
    li, ui = tmat.labeled_split(labeled)
    v = np.random.default_rng(8).standard_normal(8).astype(np.float32)
    tv = torch.from_numpy(v)

    def f(ls, eps=EPS):
        base = tmat.make_matern_precision_matvec(tg, tlap.laplacian_coeffs(tg, eps), NU, ls,
                                                 "randomwalk")
        mv = tmat.make_schur_matvec(base, li, ui, n, cg_tol=1e-8, cg_max_iter=2000)
        return torch.sum(tv * mv(tv[:, None])[:, 0])

    ls = torch.tensor(LS, requires_grad=True)
    eps = torch.tensor(EPS, requires_grad=True)
    g_ls, g_eps = torch.autograd.grad(f(ls, eps), (ls, eps))
    h = 1e-2
    with torch.no_grad():
        fd = (f(torch.tensor(LS + h)) - f(torch.tensor(LS - h))) / (2 * h)
    np.testing.assert_allclose(float(g_ls), float(fd), rtol=5e-2)

    def jf(ls, eps):
        base = jmat.make_matern_precision_matvec(jg, jlap.laplacian_coeffs(jg, eps), NU, ls,
                                                 "randomwalk")
        mv = jmat.make_schur_matvec(base, li, ui, n, cg_tol=1e-8, cg_max_iter=2000)
        return jnp.sum(jnp.asarray(v) * mv(jnp.asarray(v)[:, None])[:, 0])

    jg_ls, jg_eps = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.float32(LS), jnp.float32(EPS))
    np.testing.assert_allclose([float(g_ls), float(g_eps)], [float(jg_ls), float(jg_eps)],
                               rtol=1e-3)
    assert abs(float(g_eps)) > 0.0


def test_iteration_log_labels_the_inner_solves(graphs):
    """``ops.cg.iteration_log`` tells the Schur operator's inner solves
    (forward and adjoint) from an outer solve on it by their label, also
    when both blocks have the same number of rows. The inner solves run
    on the masked form's full-length vectors: every node's row."""
    from manifold_gp_torch.ops import cg

    _, tg = graphs
    n = tg.num_nodes - tg.num_nodes % 2
    labeled = np.zeros(tg.num_nodes, bool)
    labeled[: n // 2] = True
    n_lab = int(labeled.sum())
    li, ui = tmat.labeled_split(labeled)
    ls = torch.tensor(LS, requires_grad=True)
    base = tmat.make_matern_precision_matvec(tg, tlap.laplacian_coeffs(tg, EPS), NU, ls,
                                             "randomwalk")
    mv = tmat.make_schur_matvec(base, li, ui, tg.num_nodes, cg_tol=1e-6, cg_max_iter=500)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((n_lab, 2)).astype(np.float32))
    cg.iteration_log = []
    try:
        x = cg.cg_solve(mv, b, tol=1e-4, max_iter=500)
        torch.autograd.grad(torch.sum(x * b), ls)
        log = cg.iteration_log
    finally:
        cg.iteration_log = None
    inner = [e for e in log if e[0] == "schur_inner"]
    outer = [e for e in log if e[0] is None]
    assert {e[1] for e in inner} == {tg.num_nodes} and {e[1] for e in outer} == {n_lab}
    # two outer solves (forward, adjoint); each outer iteration's apply runs
    # one inner solve, and the backward's operator VJP runs more (forward
    # and adjoint inner solves), all labeled
    assert len(outer) == 2 and all(it > 0 for *_, it in log)
    assert len(inner) > sum(it for *_, it in outer)
    assert cg.iteration_log is None


def _semisup_models(x, y, labeled, **cfg_kw):
    """The same semisupervised problem as a JAX and a port model (the
    kernel of tests/test_models.py::_make_model)."""
    kw = dict(max_cholesky=800)
    kw.update(cfg_kw)
    jc, tc = J.InferenceConfig(**kw), T.InferenceConfig(**kw)
    common = dict(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                  num_modes=20, bump_scale=10.0, bump_decay=1.0)
    jk = J.RiemannMaternKernel(cfg=jc, **common)
    tk = T.RiemannMaternKernel(cfg=tc, device="cpu", **common)
    return (J.RiemannGP(x[labeled], jnp.asarray(y[labeled]), jk, labeled=labeled, cfg=jc),
            T.RiemannGP(x[labeled], y[labeled], tk, labeled=labeled, cfg=tc))


def _loss_and_grads(jm, tm, init, probes=None, monkeypatch=None):
    if probes is not None:
        monkeypatch.setattr(jengine, "rademacher_probes",
                            lambda key, n_, p_: jnp.asarray(probes))
    # jitted: eager JAX compiles every nested CG loop anew (5x slower here)
    jl, jgr = jax.jit(jax.value_and_grad(lambda p: jm.mll_loss(p, key=jax.random.PRNGKey(0))))(
        jm.init_params(**init))
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**init).items()}
    tl = tm.mll_loss(tp, probes=None if probes is None else torch.from_numpy(probes))
    tgr = torch.autograd.grad(tl, [tp[k] for k in RAW])
    return (float(jl), np.array([float(jgr[k]) for k in RAW]), float(tl.detach()),
            np.array([float(g) for g in tgr]))


def test_semisupervised_schur_training():
    """Twin of test_models.py::test_semisupervised_schur_training: the
    exact-regime loss (the Schur operator densified and factorized, 20
    labeled nodes) against JAX's (value 1e-4, gradients 5e-3 of the largest:
    inner CG at 1e-2 on both sides), then 5 epochs of
    ``manifold_informed_train``, finite."""
    x, y = small_cloud()
    labeled = np.zeros(x.shape[0], bool)
    labeled[::8] = True
    jm, tm = _semisup_models(x, y, labeled)
    init = dict(noise=1e-2, outputscale=1.0, graphbandwidth=EPS, lengthscale=1.0)
    jl, jgr, tl, tgr = _loss_and_grads(jm, tm, init)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tgr, jgr, atol=5e-3 * np.abs(jgr).max())
    params = tm.init_params(**init)
    params, _, history = manifold_informed_train(tm, params, lr=0.1, max_iter=5)
    assert len(history) == 6 and np.all(np.isfinite(history))
    assert all(np.isfinite(float(v.detach())) for v in params.values())


@pytest.mark.parametrize("precondition", [False, True])
def test_model_loss_same_with_precondition(precondition, monkeypatch):
    """Twin of the semisupervised case of
    test_precondition.py::test_model_loss_same_with_precondition, in the
    stochastic regime (max_cholesky=0, 32 shared probes, CG at 1e-5): the
    port's loss and gradients equal JAX's with and without the Jacobi
    preconditioners (the outer one on the labeled rows, the inner one on
    the unlabeled block), and preconditioning moves them only by the CG
    tolerance (the JAX test's rtol 1e-3 / 2e-2)."""
    x, y = small_cloud()
    labeled = np.zeros(len(y), bool)
    labeled[::8] = True
    kw = dict(max_cholesky=0, num_probes=32, cg_tolerance=1e-5, cg_max_iter=2000)
    init = dict(noise=1e-3, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)
    probes = _rademacher(int(labeled.sum()), 32, seed=7)
    jm, tm = _semisup_models(x, y, labeled, cg_precondition=precondition, **kw)
    jl, jgr, tl, tgr = _loss_and_grads(jm, tm, init, probes, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tgr, jgr, atol=5e-3 * np.abs(jgr).max())
    _, other = _semisup_models(x, y, labeled, cg_precondition=not precondition, **kw)
    tp = {k: v.requires_grad_(True) for k, v in other.init_params(**init).items()}
    ol = other.mll_loss(tp, probes=torch.from_numpy(probes))
    og = np.array([float(g) for g in torch.autograd.grad(ol, [tp[k] for k in RAW])])
    np.testing.assert_allclose(float(ol), tl, rtol=1e-3)
    np.testing.assert_allclose(og, tgr, rtol=2e-2, atol=1e-4)


def _medium(n=600, seed=42):
    """tests/test_schur_medium.py's noisy circle, cut from 1,200 to n points."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    y = np.sin(3 * t)
    labeled = np.zeros(n, bool)
    labeled[rng.permutation(n)[: n // 10]] = True
    return x.astype(np.float32), y.astype(np.float32), labeled


def test_schur_quad_matches_dense_oracle_at_600():
    """Small case of test_schur_medium.py::test_schur_mll_matches_dense_oracle_at_1200
    (600 points, 60 labeled, the block path of the default layout): the
    quadratic term of the noisy scaled Schur operator against the dense
    oracle (the JAX test's rtol 2e-3) and JAX's (1e-5)."""
    x, y, labeled = _medium()
    n = x.shape[0]
    eps, ls, scale, noise = 0.25, 1.0, 1.3, 1e-2
    kw = dict(max_cholesky=0, cg_tolerance=1e-6, cg_max_iter=3000,
              dense_operator_max_size=0, use_block_sparse=True)
    common = dict(nu=NU, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                  num_modes=10)
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(**kw), device="cpu", **common)
    assert tk.block_layout is not None
    tm = T.RiemannGP(x[labeled], y[labeled], tk, labeled=labeled, cfg=T.InferenceConfig(**kw))
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(**kw), **common)
    jm = J.RiemannGP(x[labeled], jnp.asarray(y[labeled]), jk, labeled=labeled,
                     cfg=J.InferenceConfig(**kw))
    hyp = dict(noise=noise, outputscale=scale, graphbandwidth=eps, lengthscale=ls)
    yl = y[labeled]
    quad = float(torch.dot(torch.from_numpy(yl),
                           tm.precision_matvec(tm.init_params(**hyp))(torch.from_numpy(yl))))
    jquad = float(jnp.dot(jnp.asarray(yl),
                          jm.precision_matvec(jm.init_params(**hyp))(jnp.asarray(yl))))
    lap, _, _, _, deg = dense_graph_laplacian(
        np.asarray(tk.graph.rows), np.asarray(tk.graph.cols), np.asarray(tk.graph.sqdist),
        eps, n, normalization="randomwalk")
    prec = dense_noisy(dense_scaled(dense_schur_labeled(
        dense_matern_precision(lap, NU, ls, degree=deg), labeled), scale), noise)
    np.testing.assert_allclose(quad, float(yl @ (prec @ yl)), rtol=2e-3)
    np.testing.assert_allclose(quad, jquad, rtol=1e-5)


def test_semisup_training_runs_at_600():
    """Small case of test_schur_medium.py::test_semisup_training_runs_at_1200:
    five epochs of the semisupervised protocol in the stochastic regime
    (60 labeled > max_cholesky = 50) on the block path; finite loss and
    hyperparameters, and the posterior at 64 points off the graph."""
    x, y, labeled = _medium()
    yl = (y[labeled] - y[labeled].mean()) / y[labeled].std(ddof=1)
    cfg = T.InferenceConfig(max_cholesky=50, num_probes=16, lanczos_max_iter=30,
                            cg_tolerance=1e-2, cg_max_iter=400, dense_operator_max_size=0)
    kernel = T.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=6,
                                   laplacian_normalization="randomwalk", num_modes=20,
                                   cfg=cfg, device="cpu")
    model = T.RiemannGP(x[labeled], yl, kernel, labeled=labeled, cfg=cfg)
    assert not model.train_is_graph
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)
    params, loss, history = manifold_informed_train(
        model, params, lr=1e-2, max_iter=5, tolerance=0.0, num_rand_vec=50,
        scheduler=T.utils.ReduceLROnPlateau(factor=0.5, patience=50, threshold=1e-3))
    assert np.isfinite(loss) and np.all(np.isfinite(history))
    for k, v in params.items():
        assert np.isfinite(float(v.detach())), k
    model.eval(params)
    post = model.posterior(params, x[:64], is_train=False)
    assert torch.all(torch.isfinite(post.mean))


def test_forced_block_schur_loss_and_gradients_match_jax(monkeypatch):
    """The spiral's route at a small size: block-ELL forced
    (``dense_operator_max_size=0, use_dia=False``), the masked Schur
    complement in padded-RCM space (the compact labeled vectors embedded at
    the stack's boundary, nothing permuted inside an inner solve), the SLQ
    branch with 8 shared probes, the Jacobi preconditioners
    and panel-space cotangents through the plain kernel versions; loss
    (1e-4) and gradients (5e-3 of the largest; CG at 1e-5 in both
    packages) against JAX's. An inner operator that closed over its tensors
    would lose the gradient through the inner solve and fail here."""
    x, y, labeled = _medium()
    yl = (y[labeled] - y[labeled].mean()) / y[labeled].std(ddof=1)
    kw = dict(max_cholesky=0, num_probes=8, lanczos_max_iter=16, cg_tolerance=1e-5,
              cg_max_iter=2000, dense_operator_max_size=0, use_dia=False)
    common = dict(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
                  num_modes=10)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(**kw), **common)
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(**kw), device="cpu", **common)
    assert type(tk.block_layout).__name__ == "BlockLayout"
    assert tk.block_layout.max_blocks == jk.block_layout.max_blocks
    jm = J.RiemannGP(x[labeled], jnp.asarray(yl), jk, labeled=labeled, cfg=jk.cfg)
    tm = T.RiemannGP(x[labeled], yl, tk, labeled=labeled, cfg=tk.cfg)
    init = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0)
    probes = _rademacher(int(labeled.sum()), 8, seed=3)
    jl, jgr, tl, tgr = _loss_and_grads(jm, tm, init, probes, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tgr, jgr, atol=5e-3 * np.abs(jgr).max())
    assert np.all(np.abs(tgr) > 0)


def _index_form(model):
    """``model.precision_matvec`` composed in node order:
    ``make_schur_matvec`` (its boundary inside Scale and Noise) over the
    kernel's unpermuted operator (``permuted_io=False``)."""
    kernel, cfg = model.kernel, model.cfg
    li, ui = tmat.labeled_split(model.labeled)

    def precision_matvec(params, noise=True, coeffs=None):
        mv = kernel.precision_matvec(params, coeffs=coeffs, permuted_io=False)
        mv = tmat.make_schur_matvec(
            mv, li, ui, kernel.graph.num_nodes,
            cg_tol=cfg.cg_tolerance, cg_max_iter=cfg.cg_max_iter,
            precond_diag=(kernel.precision_diag(params, coeffs=coeffs)
                          if cfg.cg_precondition else None))
        mv = tmat.make_scaled_matvec(mv, model.outputscale(params))
        return tmat.make_noisy_matvec(mv, model.noise(params)) if noise else mv

    return precision_matvec


def _layout_model(cg_tolerance=1e-5, **cfg_kw):
    """A labeled model on a forced sparse layout over ``_medium``'s circle
    (600 nodes, 60 labeled; the dense operator when ``cfg_kw`` raises
    ``dense_operator_max_size``), the SLQ branch with 8 shared probes."""
    x, y, labeled = _medium()
    yl = (y[labeled] - y[labeled].mean()) / y[labeled].std(ddof=1)
    cfg = T.InferenceConfig(max_cholesky=0, num_probes=8, lanczos_max_iter=16,
                            cg_tolerance=cg_tolerance, cg_max_iter=2000,
                            **{"dense_operator_max_size": 0, **cfg_kw})
    kernel = T.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=6,
                                   laplacian_normalization="randomwalk", num_modes=10,
                                   cfg=cfg, device="cpu")
    model = T.RiemannGP(x[labeled], yl, kernel, labeled=labeled, cfg=cfg)
    probes = torch.from_numpy(_rademacher(int(labeled.sum()), 8, seed=3))
    return model, probes


_LAYOUT_INIT = dict(noise=1e-2, outputscale=1.3, graphbandwidth=0.3, lengthscale=1.0)


def _model_loss_and_grads(model, probes):
    tp = {k: v.requires_grad_(True) for k, v in model.init_params(**_LAYOUT_INIT).items()}
    loss = model.mll_loss(tp, probes=probes)
    grads = torch.autograd.grad(loss, [tp[k] for k in RAW])
    return float(loss.detach()), np.array([float(g) for g in grads])


@pytest.mark.parametrize("layout, cfg_kw", [
    ("BlockLayout", dict(use_dia=False)),
    ("BlockLayout", dict(use_dia=False, solve_cotangent="edge")),
    ("DiaLayout", dict(dia_max_offsets=48)),
], ids=["block-panel", "block-edge", "dia"])
def test_permuted_masked_schur_equals_the_index_form(layout, cfg_kw, monkeypatch):
    """On a sparse layout (padding rows included: 600 nodes in 640 padded
    block-ELL rows, or 2,048 DIA rows of halo, nodes and pad; the circle's
    25 diagonals take DIA at ``dia_max_offsets=48``) the model runs the masked
    Schur complement in padded-RCM space; its loss and gradients equal
    those of the node-order composition (``make_schur_matvec``) over the
    same kernel's unpermuted operator to f32 sum order (the same Krylov
    sequences, CG at 1e-5: 1e-7 apart)."""
    model, probes = _layout_model(**cfg_kw)
    lay = model.kernel.block_layout
    assert type(lay).__name__ == layout and lay.num_padded > lay.num_nodes
    loss, grads = _model_loss_and_grads(model, probes)
    monkeypatch.setattr(model, "precision_matvec", _index_form(model))
    index_loss, index_grads = _model_loss_and_grads(model, probes)
    np.testing.assert_allclose(loss, index_loss, rtol=1e-6)
    np.testing.assert_allclose(grads, index_grads, atol=2e-6 * np.abs(index_grads).max())
    assert np.all(np.abs(grads) > 0)


def _traced_gathers(model, probes, monkeypatch):
    """One loss and backward under tracing: (the ``schur.gathers.*``
    counters, the applies of the composed operator, the inner CG
    iterations, how many permute_in/out calls ran inside an inner solve)."""
    inside = [False]
    permutes_inside = [0]
    applies = [0]
    cg_raw = cg.cg_raw

    def flagged_cg_raw(*args, log_label=None, **kw):
        inside[0] = log_label == "schur_inner"
        try:
            return cg_raw(*args, log_label=log_label, **kw)
        finally:
            inside[0] = False

    def counting(f):
        def wrapped(*args, **kw):
            permutes_inside[0] += inside[0]
            return f(*args, **kw)
        return wrapped

    monkeypatch.setattr(cg, "cg_raw", flagged_cg_raw)
    for mod in (block_sparse, dia):
        for name in ("permute_in", "permute_out"):
            monkeypatch.setattr(mod, name, counting(getattr(mod, name)))
    composed = model.precision_matvec

    def counted(*args, **kw):
        op = composed(*args, **kw)

        def fn(v, *consts):
            applies[0] += 1
            return op.fn(v, *consts)

        return Operator(fn, op.consts)

    monkeypatch.setattr(model, "precision_matvec", counted)
    tp = {k: v.requires_grad_(True) for k, v in model.init_params(**_LAYOUT_INIT).items()}
    metrics.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            model.mll_loss(tp, probes=probes).backward()
        counters = metrics.traced()["counters"]
    finally:
        metrics.reset()
        monkeypatch.undo()
    return counters, applies[0], counters["cg.iterations.schur_inner"], permutes_inside[0]


@pytest.mark.parametrize("cg_tolerance, layout", [
    pytest.param(1e-2, True, id="0.01"),
    pytest.param(1e-4, True, id="0.0001"),
    pytest.param(1e-2, False, id="dense"),
])
def test_layout_schur_gathers_only_at_its_boundary(cg_tolerance, layout, monkeypatch):
    """The mechanism: on a block-ELL layout (edge cotangents, the torus's
    route), and in node order on the dense operator (no layout: 600 nodes
    at the default ``dense_operator_max_size``), one loss and backward
    count one ``schur.gathers.embed`` and one ``schur.gathers.select`` per
    apply of the composed operator, whatever the inner iteration count,
    and no permute_in/out runs inside an inner solve. The node-order
    composition gathers at its own boundary, once each per Schur apply
    (inside Noise: three per composed apply), and on a layout permutes
    inside its inner solves."""
    kw = dict(use_dia=False, solve_cotangent="edge") if layout else dict(
        dense_operator_max_size=4096)
    model, probes = _layout_model(cg_tolerance=cg_tolerance, **kw)
    assert (model.kernel.block_layout is not None) == layout
    counters, applies, inner_iters, permutes_inside = _traced_gathers(model, probes,
                                                                      monkeypatch)
    assert applies > 0 and inner_iters > 2 * applies
    assert counters["schur.gathers.embed"] == counters["schur.gathers.select"] == applies
    assert metrics.counter_sum(counters, "schur.gathers") == 2 * applies
    assert permutes_inside == 0
    monkeypatch.setattr(model, "precision_matvec", _index_form(model))
    counters, applies, inner_iters, permutes_inside = _traced_gathers(model, probes,
                                                                      monkeypatch)
    schur_applies = metrics.counter_sum(counters, "schur.applies")
    assert schur_applies == 3 * applies
    assert metrics.counter_sum(counters, "schur.gathers") == 2 * schur_applies
    if layout:
        assert permutes_inside >= 2 * inner_iters
    else:
        assert permutes_inside == 0


def test_deflation_refuses_a_labeled_model():
    x, y = small_cloud()
    labeled = np.zeros(x.shape[0], bool)
    labeled[::8] = True
    _, tm = _semisup_models(x, y, labeled)
    with pytest.raises(ValueError, match="semisupervised"):
        tm.deflation_precond(tm.init_params(noise=1e-2, outputscale=1.0,
                                            graphbandwidth=EPS, lengthscale=1.0))


def test_average_variance_uses_every_node(monkeypatch):
    """``average_variance`` of a labeled model runs over the kernel's full
    precision at all N graph nodes, not the labeled block (JAX's
    ``models/riemann_gp.py::average_variance``): equal to JAX's on shared
    indices, and to the supervised model's on the same kernel."""
    x, y = small_cloud()
    labeled = np.zeros(x.shape[0], bool)
    labeled[::8] = True
    jm, tm = _semisup_models(x, y, labeled, cg_tolerance=1e-6)
    init = dict(noise=1e-2, outputscale=1.0, graphbandwidth=EPS, lengthscale=1.0)
    idx = np.random.default_rng(5).integers(0, x.shape[0], 40)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(idx))
    jav = float(jm.average_variance(jm.init_params(**init), num_rand_vec=40,
                                    key=jax.random.PRNGKey(0)))
    tav = float(tm.average_variance(tm.init_params(**init), num_rand_vec=40,
                                    idx=torch.from_numpy(idx)))
    np.testing.assert_allclose(tav, jav, rtol=1e-4)
    sup = T.RiemannGP(x, y, tm.kernel, cfg=tm.cfg)
    np.testing.assert_allclose(
        float(sup.average_variance(sup.init_params(**init), num_rand_vec=40,
                                   idx=torch.from_numpy(idx))), tav, rtol=1e-6)
