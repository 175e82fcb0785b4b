"""Matrix-free spectral-basis solver (port of the Chebyshev path of
``manifold_gp_tpu.ops.eigen``).

``chebyshev_filtered_smallest`` is Chebyshev-filtered subspace iteration:
a degree-d Chebyshev polynomial on [cut, lambda_max] amplifies the wanted
low band, applied in chunks of 64 with Gram-eigh whitening between them,
then a Rayleigh-Ritz step; the window's lower edge adapts after each outer
iteration. Every operator apply is one ``matvec`` call, so on the block-ELL
path each is one launch of the CUDA SpMV kernel (degree 256, 6 iterations:
4 * 64 + 1 applies per iteration, plus 1 final, = 1,543 applies).

``host_f64_smallest`` is the host-side float64 solver (scipy's ARPACK in
shift-invert mode over a sparse LU): for spectral bands below the f32
assembly noise floor, as on a 1-D curve at 262k points.

``lobpcg_smallest`` is block LOBPCG on the shifted operator
``upper_bound * I - A`` (the default large-N solver): a step-for-step copy
of the library routine the JAX package wraps
(``jax.experimental.sparse.linalg.lobpcg_standard``, no locking, SVQB
orthonormalization, ``P`` from the Rayleigh-Ritz rotation), private to this
module. Each iteration applies the operator twice: to ``[X, P, R]`` (3m
columns) and to ``X`` (m columns), plus one apply to the start block.

``lanczos_eigh`` is single-vector Lanczos with full reorthogonalization
(two passes a step), for LOVE's root decomposition of a train covariance.

Row-sharded blocks (``parallel``): under a mesh context LOBPCG and the
Chebyshev iteration take this rank's rows of the block, and every reduction
over rows (Gram products, column norms, the filter's rescale) goes through
``parallel.mesh``'s ``row_*`` helpers, which are the plain calls with no
mesh. The small replicated ``eigh`` / ``qr`` / ``svd`` results are rank 0's
(``replicate``), so every rank takes the same rotation; ``_extend_basis``
reads the top rows of the block, which rank 0 holds.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import active_mesh, replicate, row_gram, row_max, row_norm, row_sum


# Relative breakdown threshold: f32 residuals after double
# reorthogonalization carry ~1e-7-relative roundoff, so stop well above it.
_BREAKDOWN_RTOL = 1e-5


def lanczos_eigh(matvec: Callable, v0: torch.Tensor, num_modes: int, num_steps: int):
    """Smallest ``num_modes`` eigenpairs of the symmetric operator behind
    ``matvec`` by full-reorthogonalization Lanczos.

    Args:
      matvec: symmetric linear map [N] -> [N] (or [N, 1] -> [N, 1]).
      v0: [N] start vector (any nonzero vector; drawn by the caller).
      num_modes: number of smallest eigenpairs to return.
      num_steps: Krylov dimension m >= num_modes.

    Returns:
      (eigval [num_modes], eigvec [N, num_modes]) sorted ascending. After a
      breakdown (the Krylov space exhausted) the spurious Ritz pairs come
      back as +inf values with NaN vectors. The loop makes no host read:
      the breakdown flag stays a device boolean.
    """
    n = v0.shape[0]
    m = int(min(num_steps, n))
    num_modes = int(min(num_modes, m))
    dtype, device = v0.dtype, v0.device

    basis = torch.zeros((m, n), dtype=dtype, device=device)
    alphas = torch.zeros((m,), dtype=dtype, device=device)
    betas = torch.zeros((m,), dtype=dtype, device=device)
    q = v0 / torch.linalg.norm(v0)
    alive = torch.ones((), dtype=torch.bool, device=device)
    scale = torch.zeros((), dtype=dtype, device=device)
    for j in range(m):
        basis[j] = q
        w = matvec(q).reshape(q.shape)
        alpha = torch.dot(q, w)
        # Full reorthogonalization, twice: unfilled rows of ``basis`` are
        # zero and project out nothing.
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        beta = torch.linalg.norm(w)
        # a residual this far below the running operator scale is
        # reorthogonalization roundoff: the Krylov space is exhausted
        scale = torch.maximum(scale, torch.abs(alpha) + beta)
        alive_next = alive & (beta > _BREAKDOWN_RTOL * scale)
        q = torch.where(alive_next, w / torch.where(beta == 0, 1.0, beta), 0.0)
        alphas[j] = torch.where(alive, alpha, 0.0)
        betas[j] = torch.where(alive_next, beta, 0.0)
        alive = alive_next

    # Ritz pairs of the tridiagonal. After a breakdown the trailing block is
    # zero; its spurious zero Ritz values have no support on the valid rows
    # and go to +inf before sorting.
    filled = betas > 0
    valid = torch.cat([torch.ones((1,), dtype=torch.bool, device=device), filled[:-1]])
    off = betas[:-1] * filled[:-1]
    t = (torch.diag(torch.where(valid, alphas, 0.0)) + torch.diag(off, 1)
         + torch.diag(off, -1))
    evals, evecs = torch.linalg.eigh(t)
    support = torch.sum(torch.square(evecs) * valid[:, None], dim=0)
    evals = torch.where(support > 0.5, evals, torch.inf)
    sel = torch.argsort(evals, stable=True)[:num_modes]
    ritz_vec = basis.T @ evecs[:, sel]
    ritz_vec = ritz_vec / torch.linalg.norm(ritz_vec, dim=0, keepdim=True)
    return evals[sel], ritz_vec


# -- block LOBPCG (jax.experimental.sparse.linalg.lobpcg_standard) -----------


def _eigh_descending(a):
    """Eigenpairs of the symmetrized ``a``, largest first (the library's
    ``_eigh_ascending``, which despite its name returns descending order)."""
    w, v = torch.linalg.eigh((a + a.T) / 2.0)
    return replicate(w.flip(0), v.flip(1))


def _rows(x) -> int:
    """The global row count of a (row-sharded) block: shards are equal."""
    mesh = active_mesh()
    return x.shape[0] * (1 if mesh is None else mesh.world_size)


def _svqb(x):
    """Truncated orthonormal basis of ``x`` by SVQB: normalize the columns,
    eigendecompose the [k, k] Gram, scale; directions whose Gram eigenvalue
    falls below eps times the largest are zeroed, not normalized."""
    norms = row_norm(x, dim=0, keepdim=True)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = row_gram(x, x)
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5  # tau == 0: x was all zeros
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = row_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, u):
    """The component of ``u`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``, orthonormalized; columns that may have picked up a
    ``basis`` component through the normalization are zeroed, so
    ``[basis, u]`` stays zero-or-orthonormal."""
    for _ in range(2):
        u = u - basis @ row_gram(basis, u)
        u = _orthonormalize(u)
    # end on a subtraction of the basis, then drop suspicious columns
    for _ in range(2):
        u = u - basis @ row_gram(basis, u)
    norm_u = row_norm(u, dim=0, keepdim=True)
    return u * (norm_u >= 0.99).to(u.dtype)


def _rayleigh_ritz_orth(a, s):
    """Eigenpairs (descending) of ``a`` projected onto the orthonormal
    (zero columns allowed) ``s``."""
    return _eigh_descending(row_gram(s, a(s)))


def _extend_basis(x, m):
    """``m`` directions orthonormal to the orthonormal [n, k] ``x``, by a
    block Householder reflector built from the SVD of its top [k, k] block:
    H(w) maps vstack(0, I_m, 0) onto the extension.

    On a mesh the top rows live on rank 0: its [k, k] SVD and its rows
    k:k+m of ``w`` are broadcast, and rank 0 alone adds the identity."""
    n, k = x.shape
    mesh = active_mesh()
    top = mesh is None or mesh.rank == 0
    if mesh is not None and n < k + m:
        raise ValueError(f"LOBPCG on a mesh: rank 0 holds {n} rows, fewer than the "
                         f"{k + m} its start block's extension reads")
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    uvt, s, vt = replicate(u @ vt, s, vt)
    y = torch.cat([upper + uvt, lower], dim=0) if top else x
    w = y @ (vt.T * ((2.0 * (1.0 + s)) ** -0.5)[None, :])
    # w @ w[k:].T @ vstack(I_m, 0), with the product by the identity rows
    # taken as a slice
    h = -2.0 * (w @ replicate(w[k:k + m]).T)
    if top:
        h[k:k + m] += torch.eye(m, dtype=x.dtype, device=x.device)
    return h


def _lobpcg_standard(a: Callable, x: torch.Tensor, max_iter: int, tol: Optional[float]):
    """The largest ``k`` eigenpairs of the symmetric operator ``a`` from the
    [n, k] start block ``x``: (theta [k] descending, X [n, k], iterations).

    Stops after ``max_iter`` iterations, or once every residual is below
    ``tol`` relative to the f32 error of computing it. With ``tol <= 0``
    (never converged) the loop makes no host read; otherwise it reads the
    converged count once an iteration."""
    k = x.shape[1]
    n = _rows(x)
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)

    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a(x)
    if ax.shape != x.shape or ax.dtype != x.dtype:
        raise ValueError(f"the operator maps {tuple(x.shape)} {x.dtype} to "
                         f"{tuple(ax.shape)} {ax.dtype}")
    theta = row_sum(x * ax, dim=0, keepdim=True)
    r = ax - theta * x

    i = 0
    while i < max_iter:
        # invariants: X, P, R orthonormal; columns of P and R may be zero
        r = _project_out(torch.cat((x, p), dim=1), r)
        xpr = torch.cat((x, p, r), dim=1)
        theta, q = _rayleigh_ritz_orth(a, xpr)
        b = q[:, :k]
        b = b / torch.linalg.norm(b, dim=0, keepdim=True)
        x = xpr @ b
        x = x / row_norm(x, dim=0, keepdim=True)
        # P: orthogonalize vstack(0, Q[k:, :k]) against Q[:, :k] in the
        # standard basis through the quadrant Q[:k, k:], then map with XPR
        qp, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ replicate(qp))
        norm_p = row_norm(p, dim=0, keepdim=True)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a(x)
        theta = theta[None, :k]
        r = ax - theta * x
        i += 1
        if tol > 0:
            # self-consistency: |r| against the f32 error of computing it
            reltol = (row_norm(ax, dim=0) + theta[0]) * n * 10
            if int(torch.sum(row_norm(r, dim=0) < tol * reltol)) >= k:
                break
    return theta[0, :], x, i


def lobpcg_smallest(matvec: Callable, x0: torch.Tensor, upper_bound, max_iter: int = 200,
                    tol: Optional[float] = 0.0):
    """Smallest-m eigenpairs of a symmetric PSD operator by block LOBPCG on
    the shifted operator ``upper_bound * I - A``.

    The block iteration resolves degenerate and clustered low eigenvalues
    (paired harmonics, graph components), which single-vector Lanczos
    cannot.

    Args:
      matvec: the operator A, [N, m] -> [N, m] and [N, 3m] -> [N, 3m].
      x0: [N, m] start block (drawn by the caller).
      upper_bound: scalar >= lambda_max(A) (``gershgorin_bound``).
      tol: residual tolerance. The default 0.0 runs all ``max_iter``
        iterations: convergence is measured against the shifted eigenvalues
        (upper_bound - lambda ~ upper_bound), which would declare the
        smallest-lambda modes converged far too early.
    Returns: (eigval [m] ascending, eigvec [N, m]).
    """
    c = torch.as_tensor(upper_bound, dtype=x0.dtype, device=x0.device).reshape(())

    def shifted(v):
        return c * v - matvec(v)

    theta, u, _ = _lobpcg_standard(shifted, x0, max_iter, tol)
    vals = c - theta
    order = torch.argsort(vals, stable=True)
    return vals[order], u[:, order]


def _whiten(x):
    """Gram-eigh orthonormalization, twice for f32 stability. Near-null
    directions of the Gram are clamped, not fatal."""
    for _ in range(2):
        g = row_gram(x, x)
        lam, q = torch.linalg.eigh((g + g.T) / 2.0)
        lam, q = replicate(lam, q)
        lam = torch.maximum(lam, 1e-12 * torch.max(lam))
        x = x @ (q / torch.sqrt(lam)[None, :])
    return x


def chebyshev_filtered_smallest(
    matvec: Callable,
    x0: torch.Tensor,
    upper_bound,
    num_modes: Optional[int] = None,
    degree: int = 256,
    num_iters: int = 6,
    cut_init_frac: float = 1e-2,
):
    """Smallest-m eigenpairs by Chebyshev-filtered subspace iteration.

    Args:
      matvec: symmetric linear map [N, mb] -> [N, mb].
      x0: [N, mb] start block; oversample mb ~ 1.25x the wanted modes.
      upper_bound: any bound on lambda_max (``gershgorin_bound``).
      num_modes: wanted modes (default: the full block).
    Returns: (eigval [num_modes] ascending, eigvec [N, num_modes]).
    """
    m_block = x0.shape[1]
    m = m_block if num_modes is None else int(num_modes)
    lam_max = torch.as_tensor(upper_bound, dtype=torch.float32, device=x0.device).reshape(())

    # Chunked filters with re-whitening keep the block numerically full-rank
    # (one degree-256 application collapses every column onto the lowest
    # band).
    chunk = 64
    n_chunks = max(1, degree // chunk)

    def filter_block(x, cut):
        e = (lam_max - cut) / 2.0
        c = (lam_max + cut) / 2.0
        for _ in range(n_chunks):
            y_prev = x
            y = (matvec(x) - c * x) / e
            for _ in range(1, chunk):
                y_next = (2.0 / e) * (matvec(y) - c * y) - y_prev
                # consistent pair rescale keeps the recurrence exact
                s = torch.clamp(row_max(torch.abs(y_next)), min=1e-30)
                y_prev, y = y / s, y_next / s
            x = _whiten(y)
        return x

    def rayleigh_ritz(x):
        x = _whiten(x)
        ax = matvec(x)
        h = row_gram(x, ax)
        h = (h + h.T) / 2.0
        vals, w = torch.linalg.eigh(h)
        vals, w = replicate(vals, w)
        return vals, x @ w

    x = x0
    cut = cut_init_frac * lam_max
    for _ in range(num_iters):
        x = filter_block(x, cut)
        vals, x = rayleigh_ritz(x)
        # Tighten toward the block's top Ritz value when the whole block is
        # captured below the window, otherwise widen it (x2).
        captured = torch.sum(vals < 0.9 * cut)
        tightened = torch.minimum(torch.maximum(1.2 * vals[-1], 1e-12 * lam_max), cut)
        widened = torch.minimum(2.0 * cut, 0.9 * lam_max)
        cut = torch.where(captured >= m_block, tightened, widened)
    vals, x = rayleigh_ritz(x)
    return vals[:m], x[:, :m]


def host_f64_smallest(graph, graphbandwidth, num_modes: int, self_loops: bool = True):
    """Exact float64 low eigenpairs of the symmetric diffusion-maps
    Laplacian on the host (port of ``manifold_gp_tpu.ops.eigen.host_f64_smallest``).

    Every f32 path assembles diag and off-diagonals with independent
    roundings, so the cancellation that defines the low quadratic form
    carries ~1e-7 lambda_max of noise; a 1-D curve's low band lies below it
    at 262k points. This recomputes the coefficients of
    ``ops.laplacian.laplacian_coeffs`` in f64 from the graph's stored edge
    sqdists, assembles the sparse f64 L_sym and asks ARPACK for the
    smallest ``num_modes`` pairs in shift-invert mode, with a fixed start
    vector (reruns are bitwise identical).

    Returns numpy arrays (eigval [m] f64 ascending, eigvec [N, m] f64 of the
    symmetric form, deg [N] f64); the caller applies the randomwalk
    recovery.
    """
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    eps2 = float(graphbandwidth) ** 2
    rows = graph.rows.cpu().numpy()
    cols = graph.cols.cpu().numpy()
    sqd = graph.sqdist.cpu().numpy().astype(np.float64)
    mask = graph.mask.cpu().numpy().astype(np.float64)
    n = int(graph.num_nodes)
    m = int(min(num_modes, n))

    w = np.exp(-sqd / (4.0 * eps2)) * mask
    q = np.full(n, 1.0 if self_loops else 0.0)
    np.add.at(q, rows, w)
    np.add.at(q, cols, w)
    adj = w / (q[rows] * q[cols])
    deg = q**-2.0 if self_loops else np.zeros(n)
    np.add.at(deg, rows, adj)
    np.add.at(deg, cols, adj)
    if self_loops:
        diag = (1.0 - q**-2.0 / deg) / eps2
    else:
        diag = np.full(n, 1.0 / eps2)
    dsq = np.sqrt(deg)
    triu = adj / (dsq[rows] * dsq[cols]) / eps2

    lap = (
        sp.coo_matrix((diag, (np.arange(n), np.arange(n))), (n, n))
        + sp.coo_matrix((-triu, (rows, cols)), (n, n))
        + sp.coo_matrix((-triu, (cols, rows)), (n, n))
    ).tocsc()

    if m >= n - 1:
        vals, vecs = np.linalg.eigh(lap.toarray())
        return vals[:m], vecs[:, :m], deg
    # sigma slightly below the spectrum: L_sym is PSD with lambda_0 ~ 0, so
    # sigma = 0 risks a singular factorization; back off if it is.
    scale = float(np.max(diag))
    v0 = np.full(n, 1.0 / np.sqrt(n))
    last_err = None
    for sigma_frac in (1e-10, 1e-6, 1e-3):
        try:
            vals, vecs = spla.eigsh(lap, k=m, sigma=-sigma_frac * scale, which="LM",
                                    mode="normal", v0=v0)
            order = np.argsort(vals)
            return vals[order], vecs[:, order], deg
        except Exception as e:  # singular factorization: back off the shift
            last_err = e
    raise RuntimeError(f"host_f64 shift-invert eigsh failed: {last_err}")
