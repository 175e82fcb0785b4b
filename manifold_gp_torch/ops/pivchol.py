"""Preconditioners: Jacobi, partial pivoted Cholesky, spectral deflation
(port of ``manifold_gp_tpu.ops.pivchol``, the classes that take no mask).

Every object follows one protocol, consumed by CG (``apply``: M^{-1} v) and
by the preconditioned SLQ quadrature of ``ops.slq.slq_logdet_mbcg``
(``apply``, ``logdet``, ``sample``: probes with E[z z'] = M, and
``unit_sample``: probes with E[z z'] = I). Probes are Rademacher draws from
an explicit ``torch.Generator``.

  * ``DiagPrecond``          — M = diag(d) (Jacobi);
  * ``LowRankDiagPrecond``   — M = L L' + diag(d), applied by Woodbury: the
                               pivoted-Cholesky preconditioner;
  * ``pivoted_cholesky``     — rank-r greedy factorization from matvecs alone
                               (one [n, 1] matvec per step);
  * ``DeflationPrecond``     — M = V diag(q) V' + tau (I - V V'): deflates
                               known low modes of the operator;
  * ``ConjugatedPrecond``    — M = diag(d) M_inner diag(d), the degree wrap
                               that carries a symmetric-core preconditioner
                               to the randomwalk operator.

A preconditioner never changes solutions, so its tensors are built under
``torch.no_grad()`` and detached: its parameter dependence must not leak
into gradients. The products inside the objects are plain f32 matrix
products (TF32 is off package-wide).

The masked (padded row space) classes belong to the multi-GPU path and are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .slq import rademacher_probes


def _rademacher(generator: torch.Generator, rows: int, num_probes: int, like: torch.Tensor):
    return rademacher_probes(generator, rows, num_probes, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class DiagPrecond:
    """M = diag(d) (Jacobi)."""

    d: torch.Tensor  # [n] > 0

    def apply(self, v):
        return v / (self.d if v.dim() == 1 else self.d[:, None])

    def logdet(self):
        return torch.sum(torch.log(self.d))

    def sample(self, generator: torch.Generator, num_probes: int):
        """z with E[z z'] = M: sqrt(d) * Rademacher."""
        z = _rademacher(generator, self.d.shape[0], num_probes, self.d)
        return torch.sqrt(self.d)[:, None] * z

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        """z with E[z z'] = I (plain Rademacher): the probes the Hutchinson
        gradient identity needs."""
        return _rademacher(generator, self.d.shape[0], num_probes, self.d)


@dataclasses.dataclass(frozen=True)
class LowRankDiagPrecond:
    """M = L L' + diag(d), applied via Woodbury.

    M^{-1} = D^{-1} - D^{-1} L C^{-1} L' D^{-1},  C = I_r + L' D^{-1} L
    log det M = log det D + log det C
    """

    L: torch.Tensor  # [n, r]
    d: torch.Tensor  # [n] > 0 (clamped residual diagonal)
    chol_c: torch.Tensor  # [r, r] lower Cholesky factor of the capacitance C

    def apply(self, v):
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        div = vv / self.d[:, None]
        u = torch.cholesky_solve(self.L.T @ div, self.chol_c)
        out = div - (self.L @ u) / self.d[:, None]
        return out[:, 0] if squeeze else out

    def logdet(self):
        return torch.sum(torch.log(self.d)) + 2.0 * torch.sum(
            torch.log(torch.diagonal(self.chol_c))
        )

    def sample(self, generator: torch.Generator, num_probes: int):
        """z = L z1 + sqrt(d) z2 with independent Rademacher z1 [r, P] and
        z2 [n, P] (drawn in that order): E[z z'] = L L' + diag(d) = M."""
        n, r = self.L.shape
        z1 = _rademacher(generator, r, num_probes, self.L)
        z2 = _rademacher(generator, n, num_probes, self.L)
        return self.L @ z1 + torch.sqrt(self.d)[:, None] * z2

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return _rademacher(generator, self.L.shape[0], num_probes, self.L)


@torch.no_grad()
def pivoted_cholesky(matvec: Callable, diag0: torch.Tensor, rank: int):
    """Rank-r partial pivoted Cholesky of the SPD operator behind ``matvec``
    from matvecs alone: A ~= L L' + diag(d_res).

    Greedy largest-residual-diagonal pivoting; each of the r steps applies
    the operator to one pivot one-hot ([n, 1]). The pivot stays a device
    tensor (argmax, one-hot by comparison, gathers and masked writes), so
    the r steps enqueue without a host synchronisation, as the reference's
    ``lax.scan`` does. ``torch.argmax`` keeps the first maximum, as
    ``jnp.argmax`` does.

    Returns (L [n, r], d_res [n] >= 0), detached.
    """
    diag0 = diag0.detach()
    n = diag0.shape[0]
    rank = int(min(rank, n))
    rows = torch.arange(n, device=diag0.device)
    bigl = torch.zeros((n, rank), dtype=diag0.dtype, device=diag0.device)
    d = diag0.clone()
    keep_above = 1e-10 * torch.max(diag0)
    for i in range(rank):
        j = torch.argmax(d).reshape(1)
        hot = rows == j
        col = matvec(hot.to(diag0.dtype)[:, None])[:, 0]
        col = col - bigl @ bigl.index_select(0, j)[0]
        dj = d.index_select(0, j)
        ell = col * torch.rsqrt(torch.clamp(dj, min=1e-12))
        # degenerate pivot (operator numerically rank-deficient): stop adding
        ell = torch.where(dj > keep_above, ell, torch.zeros_like(ell))
        bigl[:, i] = ell
        d = torch.clamp(d - ell * ell, min=0.0)
        d = torch.where(hot, torch.zeros_like(d), d)
    return bigl, d


@torch.no_grad()
def make_pivchol_precond(
    matvec: Callable, diag0: torch.Tensor, rank: int, min_diag_frac: float = 1e-4
) -> LowRankDiagPrecond:
    """The pivoted-Cholesky preconditioner M = L L' + diag(d_clamped) for the
    operator behind ``matvec`` (with known/approximate diagonal ``diag0``).

    The residual diagonal is floored at its own MEAN (not just epsilon):
    pivoted rows have exactly-zero residuals, and tiny d entries make the
    Woodbury capacitance C = I + L' D^{-1} L unfactorizable in f32
    (kappa(C) ~ ||L||^2 / d_min). ``torch.linalg.cholesky`` raises on a C
    that is not positive definite."""
    diag0 = diag0.detach()
    bigl, d_res = pivoted_cholesky(matvec, diag0, rank)
    floor = torch.maximum(torch.mean(d_res), min_diag_frac * torch.mean(diag0))
    d = torch.maximum(d_res, floor)
    r = bigl.shape[1]
    c = torch.eye(r, dtype=bigl.dtype, device=bigl.device) + bigl.T @ (bigl / d[:, None])
    return LowRankDiagPrecond(L=bigl, d=d, chol_c=torch.linalg.cholesky(c))


@dataclasses.dataclass(frozen=True)
class DeflationPrecond:
    """M = V diag(q) V' + tau (I - V V') with orthonormal V [n, m].

    Matches the operator exactly on span(V) (q = the operator's eigenvalues
    there) and is a scalar tau on the complement:
      M^{-1} = V diag(1/q - 1/tau) V' + (1/tau) I
      log det M = sum log q + (n - m) log tau
      M^{1/2} z = V diag(sqrt(q) - sqrt(tau)) V' z + sqrt(tau) z
    """

    v: torch.Tensor  # [n, m] orthonormal columns
    q: torch.Tensor  # [m] > 0 deflated eigenvalues
    tau: torch.Tensor  # scalar bulk eigenvalue scale

    def apply(self, x):
        squeeze = x.dim() == 1
        xx = x[:, None] if squeeze else x
        w = self.v.T @ xx
        out = xx / self.tau + self.v @ ((1.0 / self.q - 1.0 / self.tau)[:, None] * w)
        return out[:, 0] if squeeze else out

    def logdet(self):
        n, m = self.v.shape
        return torch.sum(torch.log(self.q)) + (n - m) * torch.log(self.tau)

    def sample(self, generator: torch.Generator, num_probes: int):
        z = _rademacher(generator, self.v.shape[0], num_probes, self.v)
        w = self.v.T @ z
        return torch.sqrt(self.tau) * z + self.v @ (
            (torch.sqrt(self.q) - torch.sqrt(self.tau))[:, None] * w
        )

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return _rademacher(generator, self.v.shape[0], num_probes, self.v)


@dataclasses.dataclass(frozen=True)
class ConjugatedPrecond:
    """M = diag(d) M_inner diag(d): a diagonal similarity wrap of any
    preconditioner object.

    The telescoped randomwalk Matérn stack is
    Q_rw = D^{1/2} (shift I + L_sym)^nu D^{1/2}, so a preconditioner for the
    symmetric core extends to the randomwalk stack by conjugating with
    d = sqrt(deg) (approximate for the noisy stack: the Neumann terms
    interleave with D).

      M^{-1} x  = D^{-1} M_i^{-1} D^{-1} x           (D = diag(d))
      logdet M  = logdet M_i + 2 sum log d
      F = D M_i^{1/2}  =>  F F' = M  (sample = d * inner.sample)
    """

    d: torch.Tensor  # [n] > 0 conjugation diagonal
    inner: object  # any preconditioner object of this module

    def apply(self, v):
        d = self.d if v.dim() == 1 else self.d[:, None]
        return self.inner.apply(v / d) / d

    def logdet(self):
        return self.inner.logdet() + 2.0 * torch.sum(torch.log(self.d))

    def sample(self, generator: torch.Generator, num_probes: int):
        return self.d[:, None] * self.inner.sample(generator, num_probes)

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return self.inner.unit_sample(generator, num_probes)


def make_deflation_precond(eigvec, q, tau, mask=None) -> DeflationPrecond:
    """Deflation preconditioner from m known (orthonormal) eigenvectors of
    the operator with eigenvalues ``q`` and bulk scale ``tau``. All inputs
    are detached. ``mask`` (padded row spaces of the multi-GPU path) is not
    ported yet."""
    if mask is not None:
        _multi_gpu("make_deflation_precond(mask=...)")
    q = torch.clamp(torch.as_tensor(q).detach(), min=1e-20)
    tau = torch.as_tensor(tau, dtype=q.dtype, device=q.device).detach().reshape(())
    return DeflationPrecond(v=eigvec.detach(), q=q, tau=tau)


def _multi_gpu(name: str):
    raise NotImplementedError(
        f"{name}: the masked (padded row space) preconditioners belong to the "
        "multi-GPU path, not ported yet (ROADMAP queue 1, 'Multi-GPU, last')"
    )


def make_pivchol_precond_masked(*args, **kwargs):
    _multi_gpu("make_pivchol_precond_masked")


class _MultiGPU:
    def __init__(self, *args, **kwargs):
        _multi_gpu(type(self).__name__)


class MaskedDiagPrecond(_MultiGPU):
    pass


class MaskedLowRankDiagPrecond(_MultiGPU):
    pass


class MaskedDeflationPrecond(_MultiGPU):
    pass
