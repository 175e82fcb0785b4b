"""Port vs JAX: ``tests/test_regressions.py``'s determinism and debug-flag
checks, on that file's model (the 160-point circle, k = 6, nu = 2, exact
Cholesky loss below max_cholesky = 800), and the port's per-node edge sums,
which keep the scatter-adds' order without their atomic sums on CUDA. The dumbbell bandwidth pair is
twinned in ``test_torch_datasets.py``, the skewed-data IVF check in
``test_torch_ivf.py``."""

import jax
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_torch.ops.graph import build_graph
from manifold_gp_torch.ops.laplacian import incident_sum
from manifold_gp_torch.utils import manifold_informed_train

INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=1.0)


def _models(x, y):
    kw = dict(nu=2, x=x, nearest_neighbors=6, laplacian_normalization="randomwalk",
              num_modes=20, bump_scale=10.0, bump_decay=1.0)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(max_cholesky=800), **kw)
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(max_cholesky=800), device="cpu", **kw)
    jm = J.RiemannGP(x, y, jk, noise_constraint=J.GreaterThan(1e-8),
                     cfg=J.InferenceConfig(max_cholesky=800))
    tm = T.RiemannGP(x, y, tk, noise_constraint=T.GreaterThan(1e-8),
                     cfg=T.InferenceConfig(max_cholesky=800))
    return jm, tm


def test_loss_and_grads_bitwise_deterministic():
    """Same inputs and the same generator seed => bitwise-identical loss and
    gradients on the CPU, across two calls; and the loss and gradients at
    the JAX test's point equal JAX's within f32 rounding."""
    x, y = small_cloud()
    jm, tm = _models(x, y)
    names = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")

    def loss_and_grads():
        p = {k: v.requires_grad_(True) for k, v in tm.init_params(**INIT).items()}
        loss = tm.mll_loss(p, generator=torch.Generator().manual_seed(42))
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        return loss.detach().numpy(), [g.numpy() for g in grads]

    l1, g1 = loss_and_grads()
    l2, g2 = loss_and_grads()
    assert l1.tobytes() == l2.tobytes()
    for k, a, b in zip(names, g1, g2):
        assert a.tobytes() == b.tobytes(), k
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.mll_loss(p, key=jax.random.PRNGKey(42))))(
        jm.init_params(**INIT))
    np.testing.assert_allclose(l1, float(jl), rtol=2e-5)
    want = np.array([float(jg[k]) for k in names])
    np.testing.assert_allclose([float(g) for g in g1], want, rtol=5e-4,
                               atol=5e-4 * np.abs(want).max())


def test_training_debug_flag_raises_on_nonfinite():
    """debug=True fails fast on a poisoned objective instead of training
    through NaNs."""
    x, y = small_cloud()
    y = np.where(np.arange(len(y)) == 0, np.nan, y).astype(np.float32)
    _, tm = _models(x, y)
    with pytest.raises(FloatingPointError):
        manifold_informed_train(tm, tm.init_params(**INIT), lr=1e-1, max_iter=3, debug=True)


def test_incident_sums_match_the_scatter_adds():
    """``incident_sum`` (the Laplacian's degrees and row sums) repeats bit
    for bit, equals the two index_add scatter-adds and JAX's ``.at[].add``
    pair within f32 rounding (an f64 sum is the reference), and its
    transposed-gather backward equals autograd through the scatter-adds bit
    for bit; a graph with a high-degree node is one of the cases."""
    x, _ = small_cloud()
    rng = np.random.default_rng(3)
    # a star: 30 points on a small ring, each with the centre among its 12
    # nearest, so the centre has ~30 incident edges
    ring = 0.05 * np.stack([np.cos(np.arange(30) * 2 * np.pi / 30),
                            np.sin(np.arange(30) * 2 * np.pi / 30)], axis=1)
    hub = np.concatenate([x, ring, np.zeros((1, 2))]).astype(np.float32)
    for points, k in ((x, 6), (hub, 12)):
        graph = build_graph(torch.from_numpy(points), k, device="cpu")
        base = torch.from_numpy(rng.standard_normal(graph.num_nodes).astype(np.float32))
        vals = torch.from_numpy(rng.standard_normal(graph.num_edges).astype(np.float32))
        weight = torch.from_numpy(rng.standard_normal(graph.num_nodes).astype(np.float32))

        def run(fn):
            b, v = base.clone().requires_grad_(True), vals.clone().requires_grad_(True)
            out = fn(b, v)
            return (out.detach(), *torch.autograd.grad((out * weight).sum(), (b, v)))

        got = run(lambda b, v: incident_sum(graph, b, v))
        again = run(lambda b, v: incident_sum(graph, b, v))
        want = run(lambda b, v: b.index_add(0, graph.rows, v).index_add(0, graph.cols, v))
        for name, a, b in zip(("sum", "base grad", "vals grad"), got, again):
            assert a.numpy().tobytes() == b.numpy().tobytes(), name
        for name, a, b in zip(("base grad", "vals grad"), got[1:], want[1:]):
            assert a.numpy().tobytes() == b.numpy().tobytes(), name
        exact = base.double().index_add(0, graph.rows, vals.double()).index_add(
            0, graph.cols, vals.double()).numpy()
        # f32 rounding of a sum of up to 1 + D terms
        bound = 1.2e-7 * (graph.max_degree + 1) * (np.abs(base.numpy()) + np.abs(
            vals.numpy())[graph.ell_edge.numpy()].sum(1))
        rows, cols = jax.numpy.asarray(graph.rows.numpy()), jax.numpy.asarray(graph.cols.numpy())
        jv = jax.numpy.asarray(vals.numpy())
        jax_sum = np.asarray(jax.numpy.asarray(base.numpy()).at[rows].add(jv).at[cols].add(jv))
        for label, approx in (("port", got[0].numpy()), ("index_add", want[0].numpy()),
                              ("jax", jax_sum)):
            assert np.all(np.abs(approx - exact) <= bound), label
    assert graph.max_degree >= 30
    with pytest.raises(ValueError):
        incident_sum(graph, base[:-1], vals)
