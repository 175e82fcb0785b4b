"""Port vs JAX vs an f64 oracle: block LOBPCG, the default basis solver
(``ops.eigen.lobpcg_smallest`` and ``eval_basis`` above ``eigh_max_size``).

Both packages get the same numpy start block and the same operator, so the
iterates differ by f32 sum order alone; eigenvalues are compared directly,
eigenvectors only through the span of each well-separated group of
eigenvalues (principal angles), never by sign or rotation inside a
degenerate cluster: the column signs of ``eigh``/``qr``/``svd`` differ
between LAPACK builds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as jmgp
import manifold_gp_torch as tmgp
from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops import eigen as jeig
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_torch.ops import eigen as teig
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap


def _sin_angle(a, b):
    """sin of the largest principal angle between span(a) and span(b)."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def _groups(w, m, gap):
    """Index ranges [lo, hi) of the eigenvalues w[:m] split where two
    neighbours are more than ``gap`` apart; the last group ends at m only
    if w[m] is also more than ``gap`` above w[m - 1]."""
    cuts = [0] + [j for j in range(1, m) if w[j] - w[j - 1] > gap]
    ends = cuts[1:] + ([m] if w[m] - w[m - 1] > gap else [])
    return list(zip(cuts, ends))


@pytest.fixture(scope="module")
def torus():
    x, _, _ = torus_points(1500, seed=4)
    tg = tgraph.build_graph(x, 10, device="cpu")
    tc = tlap.laplacian_coeffs(tg, 0.12)
    jg = jgraph.build_graph(x, 10)
    jc = jlap.laplacian_coeffs(jg, 0.12)
    assert np.array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    assert np.array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    bound = float(tlap.gershgorin_bound(tg, tc))
    w, v = scipy.linalg.eigh(tlap.laplacian_dense(tg, tc).double().numpy(),
                             subset_by_index=[0, 16])
    return x, tg, tc, jg, jc, bound, w, v


def test_lobpcg_matches_jax_on_torus_laplacian(torus):
    """200 iterations, 16 modes, the ELL matvec of each package. Tolerance:
    eigenvalues within 1e-5 of the bound of JAX's and of the f64 oracle's
    (f32 roundoff of the shifted operator bound - L; measured 1.4e-6);
    every group of eigenvalues separated by more than 1e-3 of the bound
    spans the oracle's and JAX's subspace within sin 1e-2 (after 200
    iterations JAX's own solver is up to 4e-3 from the oracle on these
    groups, the port 3e-3, the two 6e-3 apart)."""
    _, tg, tc, jg, jc, bound, w, v = torus
    m = 16
    x0 = np.random.default_rng(5).standard_normal((tg.num_nodes, m)).astype(np.float32)
    jvals, jvecs = jeig.lobpcg_smallest(
        lambda u: jlap.laplacian_matvec(jg, jc, u, "symmetric"), jnp.asarray(x0), bound)
    tvals, tvecs = teig.lobpcg_smallest(
        lambda u: tlap.laplacian_matvec(tg, tc, u, "symmetric"), torch.from_numpy(x0), bound)
    tvals, tvecs, jvecs = tvals.numpy(), tvecs.numpy(), np.asarray(jvecs)
    np.testing.assert_allclose(tvals, np.asarray(jvals), atol=1e-5 * bound)
    np.testing.assert_allclose(tvals, w[:m], atol=1e-5 * bound)
    groups = _groups(w, m, 1e-3 * bound)
    assert sum(hi - lo for lo, hi in groups) >= m // 2
    for lo, hi in groups:
        assert _sin_angle(tvecs[:, lo:hi], v[:, lo:hi]) < 1e-2, (lo, hi)
        assert _sin_angle(tvecs[:, lo:hi], jvecs[:, lo:hi]) < 1e-2, (lo, hi)


def _cluster_problem():
    """A dense SPD matrix [400, 400] with a triple eigenvalue at the bottom
    and a pair above it, its f32 copy, a Gershgorin bound and a start
    block [400, 6]."""
    rng = np.random.default_rng(11)
    n, m = 400, 6
    lam = np.concatenate([[0.1, 0.1, 0.1, 0.35, 0.35], np.linspace(0.6, 3.0, n - 5)])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((q * lam) @ q.T).astype(np.float32)
    bound = float(np.abs(a).sum(axis=1).max())
    return lam, q, a, bound, rng.standard_normal((n, m)).astype(np.float32)


def test_lobpcg_resolves_degenerate_cluster_like_jax():
    """Behind the shifted operator, the cluster's span is found with the
    default tol = 0.0 (every iteration runs, no host read). Tolerance:
    eigenvalues 1e-5 (the spectrum lies in [0.1, 3]), spans within sin
    1e-3 of the oracle's and of JAX's."""
    lam, q, a, bound, x0 = _cluster_problem()
    m = x0.shape[1]
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jvals, jvecs = jeig.lobpcg_smallest(
        lambda u: jnp.matmul(aj, u, precision="highest"), jnp.asarray(x0), bound)
    tvals, tvecs = teig.lobpcg_smallest(lambda u: at @ u, torch.from_numpy(x0), bound)
    tvals, tvecs, jvecs = tvals.numpy(), tvecs.numpy(), np.asarray(jvecs)
    np.testing.assert_allclose(tvals, lam[:m], atol=1e-5)
    np.testing.assert_allclose(tvals, np.asarray(jvals), atol=1e-5)
    for lo, hi in ((0, 3), (3, 5)):
        assert _sin_angle(tvecs[:, lo:hi], q[:, lo:hi]) < 1e-3, (lo, hi)
        assert _sin_angle(tvecs[:, lo:hi], jvecs[:, lo:hi]) < 1e-3, (lo, hi)


@pytest.mark.parametrize("tol", [None, 1e-4])
def test_lobpcg_stops_where_the_library_stops(tol):
    """With a residual tolerance (the library's default eps, and a loose
    one) the loop reads the converged count once an iteration and stops at
    the same iteration as ``jax.experimental.sparse.linalg.lobpcg_standard``
    (21 and 1 here); the eigenvalues of the shifted operator agree within
    1e-4 (f32 roundoff carried through unconverged iterates)."""
    from jax.experimental.sparse.linalg import lobpcg_standard

    _, _, a, bound, x0 = _cluster_problem()
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jtheta, _, jiters = lobpcg_standard(
        lambda u: bound * u - jnp.matmul(aj, u, precision="highest"), jnp.asarray(x0),
        m=200, tol=tol)
    ttheta, _, titers = teig._lobpcg_standard(lambda u: bound * u - at @ u,
                                              torch.from_numpy(x0), 200, tol)
    assert titers == int(jiters) < 200
    np.testing.assert_allclose(ttheta.numpy(), np.asarray(jtheta), atol=1e-4)


def test_lobpcg_helpers_match_jax():
    """The private LOBPCG steps against the library's, on one input: SVQB
    zeroes the same columns for a zero input column and orthonormalizes
    the rest within the input's span; the basis
    extension is orthonormal to its input (its value is unique up to the
    SVD's signs, which cancel)."""
    from jax.experimental.sparse import linalg as jlinalg

    rng = np.random.default_rng(12)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    x[:, 5] = 0.0
    t = teig._orthonormalize(torch.from_numpy(x)).numpy()
    j = np.asarray(jlinalg._orthonormalize(jnp.asarray(x)))
    # the library's keep mask mixes eigen and column order: the zero
    # column costs it (and the port) three of the eight directions here
    zeros = np.all(t == 0.0, axis=0)
    assert np.array_equal(zeros, np.all(j == 0.0, axis=0)) and zeros.sum() >= 1
    kept = int((~zeros).sum())
    np.testing.assert_allclose(t[:, ~zeros].T @ t[:, ~zeros], np.eye(kept), atol=1e-5)
    # which directions survive follows the Gram's eigenvectors, so only
    # their containment in span(x) is unique
    qx, _ = np.linalg.qr(x[:, np.any(x != 0.0, axis=0)].astype(np.float64))
    tk = t[:, ~zeros].astype(np.float64)
    assert np.linalg.norm(tk - qx @ (qx.T @ tk), 2) < 1e-5
    q, _ = np.linalg.qr(rng.standard_normal((300, 8)))
    q = q.astype(np.float32)
    te = teig._extend_basis(torch.from_numpy(q), 8).numpy()
    je = np.asarray(jlinalg._extend_basis(jnp.asarray(q), 8))
    np.testing.assert_allclose(te, je, atol=1e-5)
    full = np.concatenate([q, te], axis=1)
    np.testing.assert_allclose(full.T @ full, np.eye(16), atol=1e-5)


def test_eval_basis_default_solver_matches_jax(torus):
    """eval_basis above eigh_max_size with the config default (LOBPCG, 200
    iterations) in both packages, on block-ELL panels (the port's plain
    kernel version here, the CUDA kernel on a card). Their start blocks
    differ (JAX's PRNG, a torch generator), so the comparison is by
    eigenvalue (1e-5 of the
    bound, and the f64 oracle's) and by the span of each well-separated
    group after the randomwalk recovery (sin 1e-2, as above)."""
    x, tg, tc, _, _, bound, w, _ = torus
    m = 12
    kw = dict(nu=2, x=x, nearest_neighbors=10, laplacian_normalization="randomwalk",
              num_modes=m)
    cfg_kw = dict(eigh_max_size=0, dense_operator_max_size=0, use_dia=False)
    jk = jmgp.RiemannMaternKernel(cfg=jmgp.InferenceConfig(**cfg_kw), **kw)
    tk = tmgp.RiemannMaternKernel(cfg=tmgp.InferenceConfig(**cfg_kw), device="cpu", **kw)
    assert tk.cfg.eigensolver == "lobpcg" and tk.block_layout is not None
    jvals, jvecs = jk.eval_basis(jk.init_params(graphbandwidth=0.12, lengthscale=1.0))
    tvals, tvecs = tk.eval_basis(tk.init_params(graphbandwidth=0.12, lengthscale=1.0))
    tvals, tvecs, jvecs = tvals.numpy(), tvecs.numpy(), np.asarray(jvecs)
    np.testing.assert_allclose(tvals, np.asarray(jvals), atol=1e-5 * bound)
    np.testing.assert_allclose(tvals[1:], w[1:m], atol=1e-5 * bound)
    assert tvals[0] == 0.0
    for lo, hi in _groups(w, m, 1e-3 * bound):
        assert _sin_angle(tvecs[:, lo:hi], jvecs[:, lo:hi]) < 1e-2, (lo, hi)


def test_lobpcg_rejects_a_block_too_wide():
    with pytest.raises(ValueError, match="search dim"):
        teig.lobpcg_smallest(lambda u: u, torch.zeros((40, 8)), 1.0)


def test_serve_campaign_serves_with_the_default_eigensolver():
    """``serve_campaign`` with ``eigensolver="lobpcg"`` through
    ``build_campaign``'s config overrides, on a 3,000-point torus on the
    CPU: finite outputs, no kernel launch (the plain version runs for CPU
    tensors), the reference metric within 1e-2 of the exact NLL (1e-4
    measured), LOVE above the Krylov exhaustion rank (m + 1) within 0.5 of
    the exact variances (0.11 measured: the f32 cancellation of
    K** - K*t V diag(1/lam) V' Kt* at variances ~2e-5), and 32 samples
    whose mean lies within 6 standard errors of the posterior mean."""
    from examples_torch.run_large import serve_campaign

    r, _, _ = serve_campaign(n=3000, device="cpu", num_test=256, num_modes=20,
                             love_ranks=(40,), num_samples=32, eigensolver="lobpcg",
                             eigh_max_size=0)
    assert r["eigensolver"] == "lobpcg" and r["finite"]
    assert r["basis_spmv_launches"] == 0 and r["basis_spmv_launches_by_batch"] == {}
    assert abs(r["nll_noisy_test_reference"] - r["nll_noisy_test"]) <= 1e-2 * abs(
        r["nll_noisy_test"])
    assert r["love"]["40"]["var_max_rel"] < 0.5
    assert r["samples_shape"] == [32, 256] and r["samples_mean_max_z"] < 6.0
