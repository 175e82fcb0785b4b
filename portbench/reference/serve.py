"""The served predictor in float64: a basis's residuals under the
reference's own Laplacian, and the posterior mean and variance at new
points from a basis.

The posterior follows the exact feature-space (Woodbury) form: with
spectral density S(l) = (2 nu / ls^2 + l)^-nu normalized to sum 1,
  train features  Z  = sqrt(n S) * V
  test features   Z* = sqrt(n S / (1 - gb^2 l)^2, renormalized) * E V * bump
  (E: the Nystrom extension by each test point's k nearest training points)
  C = (noise / s) I + Z'Z,  mean = Z* C^-1 Z'y,  var = noise diag(Z* C^-1 Z*').
"""

from __future__ import annotations

import torch

from .graph import knn
from .operator import Coeffs, round_to


def basis_residuals(coeffs: Coeffs, eigval: torch.Tensor, eigvec: torch.Tensor):
    """Per-mode residual ||L_sym u - l u|| / bound of a returned basis
    (``eigvec`` holds D^-1/2 u, normalized, as the port returns it), with
    u = D^1/2 eigvec normalized."""
    g = coeffs.graph
    u = eigvec * torch.sqrt(coeffs.deg)[:, None]
    u = u / torch.linalg.norm(u, dim=0)
    lu = coeffs.diag[:, None] * u
    lu = lu.index_add(0, g.rows, -coeffs.off[:, None] * u[g.cols])
    lu = lu.index_add(0, g.cols, -coeffs.off[:, None] * u[g.rows])
    bound = coeffs.gershgorin()
    return torch.linalg.norm(lu - eigval[None, :] * u, dim=0) / bound


def bump(x, alpha, beta):
    inside = torch.abs(x) < alpha
    denom = torch.where(inside, x * x - alpha * alpha, torch.full_like(x, -1.0))
    return torch.where(inside, torch.exp(beta / denom + beta / (alpha * alpha)),
                       torch.zeros_like(x))


def neighbours(train_x, test_x, k: int):
    """(sqdist, idx) [nt, k]: each test point's k nearest training points."""
    return knn(train_x, test_x, k, exclude_self=False)


def orthonormality_gap(coeffs: Coeffs, eigvec: torch.Tensor) -> float:
    """max |U'U - I| over the returned basis's u = D^1/2 eigvec, each
    column normalized."""
    u = eigvec * torch.sqrt(coeffs.deg)[:, None]
    u = u / torch.linalg.norm(u, dim=0)
    gram = u.T @ u
    return float(torch.max(torch.abs(gram - torch.eye(gram.shape[0], dtype=gram.dtype,
                                                        device=gram.device))))


def posterior(coeffs: Coeffs, nbrs: tuple, y, eigval, eigvec, vals: dict, nu: int,
              bump_scale: float, bump_decay: float, precision: str = "f64"):
    """(mean, variance) at the test points whose neighbours ``nbrs`` are
    (``neighbours``), from the basis (eigval, eigvec) of the training
    points; every product's operands stored in ``precision``."""
    def rd(t):
        return round_to(t, precision)

    n = eigvec.shape[0]
    gb = vals["graphbandwidth"]
    ls2 = vals["lengthscale"] ** 2
    density = (2.0 * nu / ls2 + eigval) ** (-float(nu))
    z = torch.sqrt(density / density.sum() * n)[None, :] * eigvec
    corrected = density / (1.0 - gb * gb * eigval) ** 2
    sqd, idx = nbrs
    w = torch.exp(-sqd / (4.0 * gb * gb))
    w = w / (coeffs.deg_unnorm[idx] * w.sum(dim=1)[:, None])
    w = w / w.sum(dim=1)[:, None]
    ext = torch.einsum("tk,tkm->tm", rd(w), rd(eigvec[idx]))
    dist0 = torch.sqrt(sqd[:, 0])
    window = bump(dist0, bump_scale * gb, bump_decay)
    zs = torch.sqrt(corrected / corrected.sum() * n)[None, :] * ext * window[:, None]
    zs = torch.where((dist0 < bump_scale * gb)[:, None], zs, torch.zeros_like(zs))
    s, noise = vals["outputscale"], vals["noise"]
    c = (noise / s) * torch.eye(z.shape[1], dtype=z.dtype, device=z.device) + rd(z).T @ rd(z)
    chol = torch.linalg.cholesky(c)
    wts = torch.cholesky_solve(rd(z).T @ rd(y)[:, None], chol)[:, 0]
    mean = rd(zs) @ rd(wts)
    half = torch.linalg.solve_triangular(chol, rd(zs).T, upper=False)
    var = noise * torch.sum(half * half, dim=0)
    return mean, var
