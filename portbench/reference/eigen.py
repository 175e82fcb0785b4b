"""The lowest eigenpairs of the reference's own Laplacian, in float64, by
Chebyshev-filtered subspace iteration: a block of ``m + guard`` random
columns from a seeded generator, each pass a Chebyshev polynomial of
``degree`` in L_sym that damps [cut, bound] (the cut being the block's
largest Ritz value), an orthonormalization and a Rayleigh-Ritz step, until
the wanted modes' residuals fall below ``tol`` of the Gershgorin bound.

Rows are put in Morton (Z-curve) order of the points first, so that the
sparse products gather from nearby rows; the answer is returned in the
points' own order. The basis is post-processed as the served model
defines it: the lowest eigenvalue taken as 0 and each vector returned as
D^-1/2 u, normalized."""

from __future__ import annotations

import torch

from .operator import BlockOperator, Coeffs, Graph


def morton_order(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """A permutation of the rows of ``x`` ([n, 3]) along the Z-curve of a
    2^bits grid over their bounding box."""
    lo, hi = x.min(dim=0).values, x.max(dim=0).values
    cell = ((x - lo) / torch.clamp(hi - lo, min=1e-300) * ((1 << bits) - 1)).long()
    key = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for bit in range(bits):
        for axis in range(x.shape[1]):
            key |= ((cell[:, axis] >> bit) & 1) << (bit * x.shape[1] + axis)
    return torch.argsort(key)


def _permuted(coeffs: Coeffs, order: torch.Tensor) -> Coeffs:
    """``coeffs`` with node i renamed to its place in ``order``."""
    g = coeffs.graph
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    out = Coeffs.__new__(Coeffs)
    out.graph = Graph(rank[g.rows], rank[g.cols], g.sqdist, g.n)
    out.diag, out.off = coeffs.diag[order], coeffs.off
    out.deg, out.deg_unnorm = coeffs.deg[order], coeffs.deg_unnorm[order]
    return out


def _filter(apply, x, degree: int, cut: float, bound: float, low: float):
    """p(L) x, p the Chebyshev polynomial of ``degree`` on [cut, bound],
    scaled to 1 at ``low`` (Zhou and Saad's three-term form)."""
    e, c = (bound - cut) / 2.0, (bound + cut) / 2.0
    sigma = e / (low - c)
    tau = 2.0 / sigma
    y = (apply(x) - c * x) * (sigma / e)
    for _ in range(2, degree + 1):
        sigma_next = 1.0 / (tau - sigma)
        y_next = (apply(y) - c * y) * (2.0 * sigma_next / e) - (sigma * sigma_next) * x
        x, y, sigma = y, y_next, sigma_next
    return y


def lowest(coeffs: Coeffs, points: torch.Tensor, m: int, seed: int, guard: int = 60,
           degree: int = 40, tol: float = 1e-9, max_passes: int = 60,
           precision: str = "f64") -> dict:
    """The ``m`` lowest eigenpairs of L_sym: {"eigval" [m], "eigvec" [n, m]
    (the served form), "resid" [m] (||L u - l u|| / bound), "ritz" (the
    whole block's Ritz values, guard included), "passes", "applies"}.
    ``precision``: how the operator's coefficients and operand are stored
    in each apply (a control stores them lower)."""
    order = morton_order(points)
    pc = _permuted(coeffs, order)
    op = BlockOperator(pc, 0.0, precision)
    bound = float(coeffs.gershgorin())
    n = coeffs.graph.n
    gen = torch.Generator(device=points.device).manual_seed(int(seed))
    x = torch.randn(n, m + guard, dtype=torch.float64, device=points.device, generator=gen)
    x, _ = torch.linalg.qr(x)
    applies = 0
    for passes in range(1, max_passes + 1):
        lx = op(x)
        applies += 1
        lam, vec = torch.linalg.eigh(x.T @ lx)
        x, lx = x @ vec, lx @ vec
        resid = torch.linalg.norm(lx - x * lam[None, :], dim=0) / bound
        if float(resid[:m].max()) <= tol:
            break
        y = _filter(op, x, degree, float(lam[-1]), bound, float(lam[0]))
        applies += degree
        x, _ = torch.linalg.qr(y)
    u = torch.empty_like(x[:, :m])
    u[order] = x[:, :m]
    eigval = lam[:m].clone()
    eigval[0] = 0.0
    eigvec = u * torch.rsqrt(coeffs.deg)[:, None]
    eigvec = eigvec / torch.linalg.norm(eigvec, dim=0, keepdim=True)
    return {"eigval": eigval, "eigvec": eigvec, "resid": resid[:m], "ritz": lam,
            "passes": passes, "applies": applies}


def cluster_cut(ritz: torch.Tensor, m: int, gap: float = 1e-2) -> int:
    """The most modes, at most ``m``, that end at a gap in the spectrum:
    the largest j with ritz[j] - ritz[j - 1] > gap * ritz[j]. A basis cut
    inside a cluster of near-equal eigenvalues holds any rotation of it."""
    for j in range(m, 0, -1):
        if float(ritz[j] - ritz[j - 1]) > gap * float(ritz[j]):
            return j
    return 1
