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

LOBPCG (a wrapper of JAX's library solver) and single-vector Lanczos are
not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _whiten(x):
    """Gram-eigh orthonormalization, twice for f32 stability. Near-null
    directions of the Gram are clamped, not fatal."""
    for _ in range(2):
        g = x.T @ x
        lam, q = torch.linalg.eigh((g + g.T) / 2.0)
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
                s = torch.clamp(torch.max(torch.abs(y_next)), min=1e-30)
                y_prev, y = y / s, y_next / s
            x = _whiten(y)
        return x

    def rayleigh_ritz(x):
        x = _whiten(x)
        ax = matvec(x)
        h = x.T @ ax
        h = (h + h.T) / 2.0
        vals, w = torch.linalg.eigh(h)
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
