"""Port vs JAX vs a scipy f64 oracle: the Chebyshev-filtered subspace
iteration of the spectral basis.

Both packages get the same numpy start block, so any difference comes from
f32 sum order alone. Eigenvalues are compared directly; eigenvectors only
through their span (principal angles), never by sign or rotation inside a
degenerate cluster."""

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
