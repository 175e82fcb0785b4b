"""Port vs JAX vs a scipy f64 oracle: the Chebyshev-filtered subspace
iteration of the spectral basis.

Both packages get the same numpy start block, so any difference comes from
f32 sum order alone. Eigenvalues are compared directly; eigenvectors only
through their span (principal angles), never by sign or rotation inside a
degenerate cluster."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops import eigen as jeig
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_torch.ops import eigen as teig
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap


@pytest.fixture(scope="module")
def torus_laplacian():
    x, _, _ = torus_points(1200, seed=2)
    tg = tgraph.build_graph(x, 10, device="cpu")
    tc = tlap.laplacian_coeffs(tg, 0.12)
    lap32 = tlap.laplacian_dense(tg, tc)
    jg = jgraph.build_graph(x, 10)
    jc = jlap.laplacian_coeffs(jg, 0.12)
    bound = float(tlap.gershgorin_bound(tg, tc))
    # f64 oracle from the same f32 coefficients
    lap64 = lap32.double().numpy()
    w, v = scipy.linalg.eigh(lap64)
    return tg, tc, jg, jc, lap32, bound, w, v


def _max_principal_angle_sin(a, b):
    """sin of the largest principal angle between span(a) and span(b), as
    the norm of b's residual off span(a) (in f64; the cosine form loses half
    the digits near 1)."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def test_chebyshev_matches_jax_and_f64_oracle(torus_laplacian):
    tg, tc, jg, jc, lap32, bound, w, v = torus_laplacian
    m, mb = 12, 20
    x0 = np.random.default_rng(0).standard_normal((tg.num_nodes, mb)).astype(np.float32)
    jdense = jlap.laplacian_dense(jg, jc)
    jvals, jvecs = jeig.chebyshev_filtered_smallest(
        lambda u: jnp.matmul(jdense, u, precision="highest"), jnp.asarray(x0), bound,
        num_modes=m, degree=128, num_iters=4,
    )
    tvals, tvecs = teig.chebyshev_filtered_smallest(
        lambda u: lap32 @ u, torch.from_numpy(x0), bound, num_modes=m, degree=128,
        num_iters=4,
    )
    tvals, tvecs = tvals.numpy(), tvecs.numpy()
    # vs JAX on the same start block: f32 roundoff of the operator scale
    np.testing.assert_allclose(tvals, np.asarray(jvals), atol=1e-5 * bound)
    # vs the f64 oracle: the wanted band's eigenvalues
    np.testing.assert_allclose(tvals, w[:m], atol=1e-5 * bound)
    # subspace: compare the leading modes up to the widest spectral gap
    # inside the block (a cut inside a degenerate cluster has no unique span)
    k = 4 + int(np.argmax(w[4:m + 1] - w[3:m]))
    assert w[k] - w[k - 1] > 1e-4 * bound
    assert _max_principal_angle_sin(tvecs[:, :k], v[:, :k]) < 1e-3
    assert _max_principal_angle_sin(tvecs[:, :k], np.asarray(jvecs)[:, :k]) < 1e-3


def test_whiten_orthonormalizes_like_jax():
    x = np.random.default_rng(1).standard_normal((400, 10)).astype(np.float32)
    x[:, 8] = x[:, 7] + 1e-2 * x[:, 9]  # ill-conditioned but full rank
    x = x[:, :9]
    t = teig._whiten(torch.from_numpy(x)).numpy()
    j = np.asarray(jeig._whiten(jnp.asarray(x)))
    np.testing.assert_allclose(t.T @ t, np.eye(9), atol=1e-5)
    assert _max_principal_angle_sin(t, x) < 1e-5
    assert _max_principal_angle_sin(t, j) < 1e-5


# -- Lanczos (LOVE's root decomposition): twins of tests/test_eigen.py ------


def test_lanczos_matches_dense_eigh_and_jax_on_spd_matrix():
    """Twin of test_eigen.py::test_lanczos_matches_dense_eigh_on_spd_matrix
    on its own draw: the oracle tolerances of the JAX test, and JAX's Ritz
    values on the same start vector within 1e-5 (f32 sum order)."""
    rng = np.random.default_rng(21)
    n, m = 120, 10
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T / n + np.diag(np.linspace(0.1, 3.0, n)).astype(np.float32)
    spd = (0.5 * (spd + spd.T)).astype(np.float32)
    dense_val, dense_vec = np.linalg.eigh(spd)
    v0 = rng.standard_normal(n).astype(np.float32)
    st = torch.from_numpy(spd)
    val, vec = teig.lanczos_eigh(lambda v: st @ v, torch.from_numpy(v0), m, 3 * m + 60)
    val, vec = val.numpy(), vec.numpy()
    np.testing.assert_allclose(val, dense_val[:m], rtol=2e-3, atol=2e-4)
    for j in range(m):
        assert abs(float(vec[:, j] @ dense_vec[:, j])) > 0.99, j
    jval, _ = jeig.lanczos_eigh(lambda v: jnp.asarray(spd) @ v, jnp.asarray(v0), m, 3 * m + 60)
    np.testing.assert_allclose(val, np.asarray(jval), atol=1e-5)


def test_lanczos_on_graph_laplacian_matches_jax():
    """Twin of test_eigen.py::test_lanczos_on_graph_laplacian: the smallest
    Laplacian eigenpairs of the ELL matvec against dense eigh (the JAX
    test's tolerances: values rtol 5e-3 / atol 1e-4, residuals 5e-3,
    orthonormality 1e-4) and against JAX's Ritz values on the same start
    vector (1e-5)."""
    from _torch_data import small_cloud

    x, _ = small_cloud()
    tg = tgraph.build_graph(x, 6, device="cpu")
    tc = tlap.laplacian_coeffs(tg, 0.35)
    jg = jgraph.build_graph(x, 6)
    jc = jlap.laplacian_coeffs(jg, 0.35)
    n = tg.num_nodes
    dense = tlap.laplacian_dense(tg, tc).numpy()
    dense_val = np.linalg.eigvalsh(0.5 * (dense + dense.T))
    m = 12
    v0 = np.random.default_rng(3).standard_normal(n).astype(np.float32)

    def mv(v):
        return tlap.laplacian_matvec(tg, tc, v, "symmetric")

    val, vec = teig.lanczos_eigh(mv, torch.from_numpy(v0), m, 120)
    val, vec = val.numpy(), vec.numpy()
    np.testing.assert_allclose(val, dense_val[:m], rtol=5e-3, atol=1e-4)
    for j in range(m):
        r = mv(torch.from_numpy(vec[:, j])).numpy() - val[j] * vec[:, j]
        assert np.linalg.norm(r) < 5e-3, j
    np.testing.assert_allclose(vec.T @ vec, np.eye(m), atol=1e-4)
    jval, _ = jax.jit(lambda v: jeig.lanczos_eigh(
        lambda u: jlap.laplacian_matvec(jg, jc, u, "symmetric"), v, m, 120))(jnp.asarray(v0))
    np.testing.assert_allclose(val, np.asarray(jval), atol=1e-5)


def test_lanczos_breakdown_rank_deficient_like_jax():
    """Twin of test_eigen.py::test_lanczos_breakdown_rank_deficient: Krylov
    exhaustion (identity plus rank 3) gives no spurious small eigenvalue;
    the spurious post-breakdown pairs come back as +inf, as in JAX."""
    n = 64
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((n, 3)))
    spd = (np.eye(n) + (u * np.array([1.0, 2.0, 3.0])) @ u.T).astype(np.float32)
    v0 = rng.standard_normal(n).astype(np.float32)
    st = torch.from_numpy(spd)
    val, _ = teig.lanczos_eigh(lambda v: st @ v, torch.from_numpy(v0), num_modes=4,
                               num_steps=30)
    val = val.numpy()
    np.testing.assert_allclose(val[0], 1.0, rtol=1e-4)
    assert np.all(val >= 0.5), val
    jval, _ = jeig.lanczos_eigh(lambda v: jnp.asarray(spd) @ v, jnp.asarray(v0), 4, 30)
    np.testing.assert_allclose(val, np.asarray(jval), rtol=1e-5)
    full, vecs = teig.lanczos_eigh(lambda v: st @ v, torch.from_numpy(v0), 30, 30)
    jfull, _ = jeig.lanczos_eigh(lambda v: jnp.asarray(spd) @ v, jnp.asarray(v0), 30, 30)
    assert np.array_equal(np.isinf(full.numpy()), np.isinf(np.asarray(jfull)))
    assert np.isinf(full.numpy()).sum() > 0
    assert torch.isnan(vecs[:, torch.isinf(full)]).all()
