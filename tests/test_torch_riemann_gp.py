"""Port vs JAX, end to end: the supervised IMGP prediction slice.

Both packages build the model on the same torus sample (coordinates
rescaled to unit graph bandwidth, as in the large-N campaign) and serve the
same params dict (JAX's, carried over by ``params_from_jax``). Compared:
basis eigenvalues, posterior mean and stddev, and ``test_model`` RMSE/NLL.

Tolerance (also the chip check's, examples_torch/serve_pins.json): 1e-3
relative on RMSE/NLL, eigenvalues and posterior moments. The matrix-free
basis starts from different random blocks in the two packages (JAX's PRNG
vs a torch generator) and sums in a different f32 order; the converged
subspace agrees far closer than that (~1e-6 relative on the metrics at 16k
points on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as jmgp
import manifold_gp_torch as tmgp
from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops.graph import build_graph as jbuild_graph
from manifold_gp_tpu.utils import test_model as jax_test_model
from manifold_gp_torch.ops import cuda_spmv
from manifold_gp_torch.utils import params_from_jax, params_to_numpy
from manifold_gp_torch.utils import test_model as torch_test_model

HYPERS = dict(noise=0.002788, outputscale=2.2967, graphbandwidth=0.2374, lengthscale=3.38)
RTOL = 1e-3


def _torus_problem(n, num_test, seed=0):
    rng = np.random.default_rng(seed)
    x, u, v = torus_points(n, seed=seed)
    y_true = np.sin(2 * u) + 0.5 * np.cos(3 * u) * np.sin(2 * v)
    y = (y_true + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    te, tr = perm[:num_test], np.sort(perm[num_test:])
    mu, sd = y[tr].mean(), y[tr].std(ddof=1)
    sq = np.asarray(jbuild_graph(x[tr], 16).sqdist)
    eps = 2.0 * float(np.sqrt(np.median(sq)))
    return x[tr] / eps, (y[tr] - mu) / sd, x[te] / eps, (y[te] - mu) / sd


def _serve_both(n, num_test, num_modes, **cfg_kw):
    x_tr, y_tr, x_te, y_te = _torus_problem(n, num_test)
    out = {}
    for name, pkg, extra in (("jax", jmgp, {}), ("torch", tmgp, {"device": "cpu"})):
        cfg = pkg.InferenceConfig(**cfg_kw)
        kernel = pkg.RiemannMaternKernel(
            nu=2, x=x_tr, nearest_neighbors=16, laplacian_normalization="randomwalk",
            num_modes=num_modes, bump_scale=10.0, cfg=cfg, **extra,
        )
        out[name] = (kernel, pkg.RiemannGP(x_tr, y_tr, kernel, cfg=cfg))
    jk, jm = out["jax"]
    tk, tm = out["torch"]
    jp = jm.init_params(**HYPERS)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return (jk, jm, jp), (tk, tm, tp), x_te, y_te


def _compare(jax_side, torch_side, x_te, y_te):
    (jk, jm, jp), (tk, tm, tp) = jax_side, torch_side
    jb = jk.eval_basis(jp)
    tb = tk.eval_basis(tp)
    jvals, tvals = np.asarray(jb[0]), tb[0].numpy()
    np.testing.assert_allclose(tvals[1:], jvals[1:], rtol=RTOL)
    assert tvals[0] == 0.0
    jk.eval_basis = lambda p: jb
    tk.eval_basis = lambda p: tb
    jr, jn = jax_test_model(jm, jp, x_te, y_te, noisy_test=True)
    tr, tn = torch_test_model(tm, tp, x_te, y_te, noisy_test=True)
    assert tr == pytest.approx(jr, rel=RTOL)
    assert tn == pytest.approx(jn, rel=RTOL)
    jpost = jm.posterior(jp, x_te)
    tpost = tm.posterior(tp, x_te)
    mean_scale = np.abs(np.asarray(jpost.mean)).max()
    np.testing.assert_allclose(tpost.mean.numpy(), np.asarray(jpost.mean), atol=RTOL * mean_scale)
    np.testing.assert_allclose(tpost.stddev.numpy(), np.asarray(jpost.stddev), rtol=RTOL)
    # the posterior at the training nodes takes the in-sample feature path
    jin = jm.posterior(jp, jk.x, is_train=True)
    tin = tm.posterior(tp, tk.x, is_train=True)
    np.testing.assert_allclose(tin.mean.numpy(), np.asarray(jin.mean),
                               atol=RTOL * np.abs(np.asarray(jin.mean)).max())
    return tr


def test_serve_block_chebyshev_path_matches_jax():
    """~3k torus: block-ELL layout (plain kernel version on the CPU) and the
    Chebyshev basis, as at 262k on the card."""
    jax_side, torch_side, x_te, y_te = _serve_both(
        3072, 256, 30, dense_operator_max_size=0, eigh_max_size=0,
        eigensolver="chebyshev", use_dia=False,
    )
    tk = torch_side[0]
    assert tk.block_layout is not None and not tk.use_dense_operator
    cuda_spmv.launch_count = 0
    rmse = _compare(jax_side, torch_side, x_te, y_te)
    assert cuda_spmv.launch_count == 0  # CPU: the plain version ran
    assert rmse < 0.5


def test_serve_exact_eigh_path_matches_jax():
    """At or below eigh_max_size: dense L and dense eigh on both sides."""
    jax_side, torch_side, x_te, y_te = _serve_both(1536, 128, 20)
    assert torch_side[0].use_dense_operator
    _compare(jax_side, torch_side, x_te, y_te)


def test_params_roundtrip_and_constraints():
    x_tr, y_tr, _, _ = _torus_problem(600, 50)
    kernel = tmgp.RiemannMaternKernel(
        nu=2, x=x_tr, nearest_neighbors=8, num_modes=10,
        graphbandwidth_constraint=tmgp.GreaterThan(0.05), device="cpu",
    )
    model = tmgp.RiemannGP(x_tr, y_tr, kernel)
    p = model.init_params(**HYPERS)
    assert float(kernel.graphbandwidth(p)) == pytest.approx(0.2374, rel=1e-5)
    assert float(kernel.lengthscale(p)) == pytest.approx(3.38, rel=1e-5)
    assert float(model.noise(p)) == pytest.approx(0.002788, rel=1e-4)
    assert float(model.outputscale(p)) == pytest.approx(2.2967, rel=1e-5)
    p2 = model.set_outputscale(p, 0.5)
    assert float(model.outputscale(p2)) == pytest.approx(0.5, rel=1e-6)
    back = params_from_jax(params_to_numpy(p), "cpu")
    assert set(back) == set(p) and all(torch.equal(back[k], p[k]) for k in p)
    jk = jmgp.RiemannMaternKernel(nu=2, x=x_tr, nearest_neighbors=8, num_modes=10,
                                  graphbandwidth_constraint=jmgp.GreaterThan(0.05))
    jp = jmgp.RiemannGP(x_tr, jnp.asarray(y_tr), jk).init_params(**HYPERS)
    for k in jp:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-5)


def test_unported_paths_raise():
    """Once the paths this slice lacked; the semisupervised one is ported
    now, so the test holds that it builds and gives a finite loss."""
    x_tr, y_tr, x_te, _ = _torus_problem(600, 50)
    cfg = tmgp.InferenceConfig(eigh_max_size=0, dense_operator_max_size=0, use_dia=False)
    kernel = tmgp.RiemannMaternKernel(nu=2, x=x_tr, nearest_neighbors=8, num_modes=10,
                                      cfg=cfg, device="cpu")
    # the semisupervised path is ported: a labeled model builds on this
    # kernel (the mask covers the graph's nodes) and its loss is finite
    labeled = np.arange(len(y_tr)) % 5 == 0
    model = tmgp.RiemannGP(x_tr[labeled], y_tr[labeled], kernel, labeled=labeled, cfg=cfg)
    loss = model.mll_loss(model.init_params(**HYPERS))
    assert model.num_data == int(labeled.sum()) and np.isfinite(float(loss))


def _subspace_distance(a, b):
    """sin of the largest principal angle between the column spans."""
    qa, _ = np.linalg.qr(a.astype(np.float64))
    qb, _ = np.linalg.qr(b.astype(np.float64))
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - s.min() ** 2)))


def test_host_f64_basis_matches_jax():
    """eigensolver="host_f64" (the curve campaign's basis) on a 3,000-point
    k = 8 curve, the graph shared edge for edge: both packages run the same
    f64 scipy solve on the same sqdists, so eigenvalues agree to 1e-8 and
    the 11-mode subspaces (whole pairs of the closed curve's spectrum) to
    1e-6; then the served posterior and metrics at RTOL."""
    from examples_torch.run_large import curve_points
    from manifold_gp_tpu.ops.graph import graph_from_edges as jgraph_from_edges
    from manifold_gp_torch.ops.dia import DiaLayout
    from manifold_gp_torch.ops.graph import graph_from_edges

    n, num_test = 3256, 256
    rng = np.random.default_rng(0)
    x, t = curve_points(n, seed=0)
    y = (np.sin(3 * t) + 0.5 * np.sin(7 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    perm = rng.permutation(n)
    te, tr = perm[:num_test], np.sort(perm[num_test:])
    jg = jbuild_graph(x[tr], 8)
    eps = 2.0 * float(np.sqrt(np.median(np.asarray(jg.sqdist))))
    x_tr, x_te = x[tr] / eps, x[te] / eps
    sq = np.asarray(jg.sqdist) / np.float32(eps) ** 2
    jg = jgraph_from_edges(np.asarray(jg.rows), np.asarray(jg.cols), sq, len(tr))
    tg = graph_from_edges(np.asarray(jg.rows), np.asarray(jg.cols), sq, len(tr), device="cpu")
    mu, sd = y[tr].mean(), y[tr].std(ddof=1)
    y_tr, y_te = (y[tr] - mu) / sd, (y[te] - mu) / sd
    out = {}
    for name, pkg, graph, extra in (("jax", jmgp, jg, {}), ("torch", tmgp, tg, {"device": "cpu"})):
        cfg = pkg.InferenceConfig(dense_operator_max_size=0, eigh_max_size=0,
                                  eigensolver="host_f64", use_dia=True)
        kernel = pkg.RiemannMaternKernel(
            nu=2, x=x_tr, nearest_neighbors=8, laplacian_normalization="randomwalk",
            num_modes=11, bump_scale=10.0, cfg=cfg, graph=graph, **extra)
        out[name] = (kernel, pkg.RiemannGP(x_tr, y_tr, kernel, cfg=cfg))
    (jk, jm), (tk, tm) = out["jax"], out["torch"]
    assert isinstance(tk.block_layout, DiaLayout)
    hypers = dict(noise=0.003473, outputscale=1.9376, graphbandwidth=0.2325, lengthscale=3.0813)
    jp = jm.init_params(**hypers)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jb, tb = jk.eval_basis(jp), tk.eval_basis(tp)
    assert tb[0].device.type == "cpu" and tb[0].dtype == torch.float32
    jvals, tvals = np.asarray(jb[0]), tb[0].numpy()
    assert tvals[0] == 0.0
    np.testing.assert_allclose(tvals[1:], jvals[1:], rtol=1e-8)
    assert _subspace_distance(tb[1].numpy(), np.asarray(jb[1])) <= 1e-6
    jk.eval_basis = lambda p: jb
    tk.eval_basis = lambda p: tb
    jr, jn = jax_test_model(jm, jp, x_te, y_te, noisy_test=True)
    tr_, tn = torch_test_model(tm, tp, x_te, y_te, noisy_test=True)
    assert tr_ == pytest.approx(jr, rel=RTOL)
    assert tn == pytest.approx(jn, rel=RTOL)
