"""Port vs JAX: the kernel-level checks of ``tests/test_kernel.py`` that the
other twins cover only end to end (the Mercer sum of the in-sample
features, the out-of-sample support mask, the bump function, the precision
matvec against the dense oracle, a prebuilt graph). Each check holds the
port at the JAX test's own tolerance, and the port's numbers to JAX's on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _dense_oracles import dense_graph_laplacian, dense_matern_precision
from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_tpu.ops.bump import bump_function as j_bump
from manifold_gp_tpu.ops.graph import build_graph as j_build_graph
from manifold_gp_torch.ops.bump import bump_function as t_bump
from manifold_gp_torch.ops.graph import build_graph as t_build_graph

EPS = 0.35
KW = dict(nu=2, nearest_neighbors=6, laplacian_normalization="randomwalk", num_modes=20,
          bump_scale=10.0, bump_decay=1.0)


@pytest.fixture(scope="module")
def kernels():
    x, _ = small_cloud()
    jk = J.RiemannMaternKernel(x=x, **KW)
    tk = T.RiemannMaternKernel(x=x, device="cpu", **KW)
    jp = jk.init_params(graphbandwidth=EPS, lengthscale=1.3)
    tp = tk.init_params(graphbandwidth=EPS, lengthscale=1.3)
    return jk, jp, jk.eval_basis(jp), tk, tp, tk.eval_basis(tp)


def test_features_train_covariance(kernels):
    """In-sample features: Z Z' is the truncated Mercer expansion with the
    sum-normalized Matérn spectral density; Z Z' (sign-free) equals JAX's."""
    jk, jp, jbasis, tk, tp, tbasis = kernels
    z = tk.features_train(tp, tbasis).numpy()
    eigval, evec = tbasis[0].numpy(), tbasis[1].numpy()
    dens = (2 * tk.nu / 1.3**2 + eigval) ** (-tk.nu)
    dens = dens / dens.sum() * tk.graph.num_nodes
    expected = (evec * dens) @ evec.T
    np.testing.assert_allclose(z @ z.T, expected, rtol=1e-3, atol=5e-5)
    jz = np.asarray(jk.features_train(jp, jbasis))
    np.testing.assert_allclose(z @ z.T, jz @ jz.T, rtol=1e-3, atol=5e-5)


def test_features_test_support_mask(kernels):
    """Points far from the manifold get exactly-zero features, in both."""
    jk, jp, jbasis, tk, tp, tbasis = kernels
    far = np.full((3, 2), 50.0, np.float32)
    feats = tk.features_test(tp, tbasis, torch.from_numpy(far))
    assert torch.equal(feats, torch.zeros_like(feats))
    assert not torch.isnan(feats).any()
    np.testing.assert_array_equal(np.asarray(jk.features_test(jp, jbasis, jnp.asarray(far))),
                                  feats.numpy())


def test_bump_function_properties():
    x = np.linspace(-2, 2, 101).astype(np.float32)
    y = t_bump(torch.from_numpy(x), 1.0, 0.5).numpy()
    assert np.all(y[np.abs(x) >= 1.0] == 0)
    np.testing.assert_allclose(y[50], 1.0, rtol=1e-6)  # bump(0) = 1
    assert np.all(y >= 0) and np.all(y <= 1.0 + 1e-6)
    np.testing.assert_allclose(y, np.asarray(j_bump(jnp.asarray(x), 1.0, 0.5)), rtol=1e-6)


def test_precision_matvec_dispatch(kernels):
    """Kernel-level precision matvec equals the dense oracle (the JAX
    test's tolerance) and JAX's matvec (f32 sum order)."""
    jk, jp, _, tk, tp, _ = kernels
    lap, _, _, _, deg = dense_graph_laplacian(
        tk.graph.rows.numpy(), tk.graph.cols.numpy(), tk.graph.sqdist.numpy(), EPS,
        tk.graph.num_nodes, normalization="randomwalk")
    dense = dense_matern_precision(lap, tk.nu, 1.3, degree=deg)
    v = np.random.default_rng(11).standard_normal((tk.graph.num_nodes, 2)).astype(np.float32)
    with torch.no_grad():
        got = tk.precision_matvec(tp)(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, dense @ v, rtol=5e-3, atol=5e-4)
    want = np.asarray(jk.precision_matvec(jp)(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_kernel_accepts_prebuilt_graph():
    """RiemannMaternKernel(graph=...) keeps the given graph (no kNN build);
    its basis has the JAX kernel's eigenvalues on JAX's prebuilt graph."""
    x = np.random.default_rng(5).standard_normal((120, 3)).astype(np.float32)
    g = t_build_graph(x, 5, device="cpu")
    kw = dict(nu=1, x=x, nearest_neighbors=5, laplacian_normalization="randomwalk", num_modes=6)
    k = T.RiemannMaternKernel(graph=g, device="cpu", **kw)
    assert k.graph is g
    val, vec = k.eval_basis(k.init_params(graphbandwidth=0.5, lengthscale=1.0))
    assert vec.shape == (120, 6)
    jk = J.RiemannMaternKernel(graph=j_build_graph(x, 5), **kw)
    jval, _ = jk.eval_basis(jk.init_params(graphbandwidth=0.5, lengthscale=1.0))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-4, atol=1e-5)
