"""Preconditioners: Jacobi, partial pivoted Cholesky, spectral deflation
(port of ``manifold_gp_tpu.ops.pivchol``).

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

The masked classes (``MaskedDiagPrecond``, ``MaskedLowRankDiagPrecond``,
``MaskedDeflationPrecond``) act on a padded row space with a 0/1 support
mask, the identity off the support: the preconditioners of the multi-GPU
path (``models.riemann_gp`` on a mesh kernel). There their tensors are this
rank's rows, their sums over rows are ``parallel.mesh.row_sum`` /
``row_gram``, and their probes are this rank's rows of a draw at the
global padded shape (``_rademacher_rows``), so every rank draws the same
probes. Pivoted Cholesky picks its pivot by a global argmax of the gathered
residual diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..parallel.mesh import active_mesh, row_gram, row_max, row_sum
from .slq import rademacher_probes


def _rademacher(generator: torch.Generator, rows: int, num_probes: int, like: torch.Tensor):
    return rademacher_probes(generator, rows, num_probes, dtype=like.dtype, device=like.device)


def _rademacher_rows(generator: torch.Generator, num_probes: int, like: torch.Tensor):
    """This rank's rows of a Rademacher draw at the global row count of the
    row-sharded ``like`` (all of it with no mesh)."""
    mesh = active_mesh()
    rows = like.shape[0]
    if mesh is None:
        return _rademacher(generator, rows, num_probes, like)
    z = _rademacher(generator, rows * mesh.world_size, num_probes, like)
    return z[mesh.rank * rows:(mesh.rank + 1) * rows]


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

    On a mesh (row-sharded ``diag0`` and operator) the pivot is the argmax
    of the gathered residual diagonal, and the pivot row of L is summed from
    its owner, so every rank takes the same pivots.

    Returns (L [n, r], d_res [n] >= 0), detached.
    """
    diag0 = diag0.detach()
    mesh = active_mesh()
    n = diag0.shape[0]
    lo = 0 if mesh is None else mesh.rank * n
    rank = int(min(rank, n if mesh is None else n * mesh.world_size))
    rows = torch.arange(lo, lo + n, device=diag0.device)
    bigl = torch.zeros((n, rank), dtype=diag0.dtype, device=diag0.device)
    d = diag0.clone()
    keep_above = 1e-10 * row_max(diag0)
    for i in range(rank):
        d_all = d if mesh is None else mesh.all_gather(d)
        j = torch.argmax(d_all).reshape(1)
        hot = rows == j
        col = matvec(hot.to(diag0.dtype)[:, None])[:, 0]
        if mesh is None:
            lj = bigl.index_select(0, j)[0]
        else:
            lj = mesh.all_reduce(torch.where(hot[:, None], bigl, 0.0).sum(dim=0))
        col = col - bigl @ lj
        dj = d_all.index_select(0, j)
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
        return self.inner.logdet() + 2.0 * row_sum(torch.log(self.d))

    def sample(self, generator: torch.Generator, num_probes: int):
        return self.d[:, None] * self.inner.sample(generator, num_probes)

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return self.inner.unit_sample(generator, num_probes)


def make_deflation_precond(eigvec, q, tau, mask=None):
    """Deflation preconditioner from m known (orthonormal) eigenvectors of
    the operator with eigenvalues ``q`` and bulk scale ``tau``. All inputs
    are detached. With ``mask`` (padded row spaces, where ``eigvec``'s rows
    are embedded at the support rows and zero elsewhere) the
    :class:`MaskedDeflationPrecond` form."""
    q = torch.clamp(torch.as_tensor(q).detach(), min=1e-20)
    tau = torch.as_tensor(tau, dtype=q.dtype, device=q.device).detach().reshape(())
    if mask is not None:
        return MaskedDeflationPrecond(v=eigvec.detach(), q=q, tau=tau, mask=mask.detach())
    return DeflationPrecond(v=eigvec.detach(), q=q, tau=tau)


# -- padded row spaces (the multi-GPU path) -----------------------------------


@dataclasses.dataclass(frozen=True)
class MaskedDiagPrecond:
    """Jacobi on a padded row space: M = diag(d) on the support rows
    (mask = 1), the identity elsewhere (d carries 1.0 there). Probes are
    supported on the mask and the logdet counts support rows only, so the
    mBCG quadrature on padded vectors estimates the support block's
    logdet."""

    d: torch.Tensor  # [Np] > 0 (1.0 off support)
    mask: torch.Tensor  # [Np] 1.0 support / 0.0 padding

    def apply(self, v):
        return v / (self.d if v.dim() == 1 else self.d[:, None])

    def logdet(self):
        return row_sum(self.mask * torch.log(self.d))

    def sample(self, generator: torch.Generator, num_probes: int):
        z = _rademacher_rows(generator, num_probes, self.d)
        return (self.mask * torch.sqrt(self.d))[:, None] * z

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        """Support-masked Rademacher: padding components would run the
        gradient CG on the operator's null space (padding rows map to 0)."""
        return self.mask[:, None] * _rademacher_rows(generator, num_probes, self.d)


@dataclasses.dataclass(frozen=True)
class MaskedLowRankDiagPrecond:
    """Pivoted Cholesky on a padded row space: M = L L' + diag(d) on the
    support rows, the identity elsewhere. L's off-support rows are zero
    (pivots come from the support diagonal), d carries 1.0 there, and the
    logdet and probes count support rows only."""

    L: torch.Tensor  # [Np, r], zero rows off support
    d: torch.Tensor  # [Np] > 0, 1.0 off support
    chol_c: torch.Tensor  # [r, r] lower Cholesky of C = I_r + L' D^{-1} L
    mask: torch.Tensor  # [Np] 1.0 support / 0.0 padding

    def apply(self, v):
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        div = vv / self.d[:, None]
        u = torch.cholesky_solve(row_gram(self.L, div), self.chol_c)
        out = div - (self.L @ u) / self.d[:, None]
        return out[:, 0] if squeeze else out

    def logdet(self):
        return row_sum(self.mask * torch.log(self.d)) + 2.0 * torch.sum(
            torch.log(torch.diagonal(self.chol_c)))

    def sample(self, generator: torch.Generator, num_probes: int):
        """z = L z1 + mask * sqrt(d) z2 (z1 [r, P] drawn first): E[z z'] = M
        on the support block."""
        z1 = _rademacher(generator, self.L.shape[1], num_probes, self.L)
        z2 = _rademacher_rows(generator, num_probes, self.L)
        return self.L @ z1 + (self.mask * torch.sqrt(self.d))[:, None] * z2

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return self.mask[:, None] * _rademacher_rows(generator, num_probes, self.L)


@torch.no_grad()
def make_pivchol_precond_masked(matvec: Callable, diag0: torch.Tensor, mask: torch.Tensor,
                                rank: int, min_diag_frac: float = 1e-4
                                ) -> MaskedLowRankDiagPrecond:
    """``make_pivchol_precond`` on a padded row space: ``matvec`` is the
    padded composed operator (padding rows map to zero), ``diag0`` its
    padded diagonal, zeroed off the support before pivoting so the argmax
    never picks a padding row; the floor and the capacitance come from the
    support rows only."""
    diag0_s = torch.where(mask > 0, diag0.detach(), torch.zeros_like(diag0))
    bigl, d_res = pivoted_cholesky(matvec, diag0_s, rank)
    n_sup = torch.clamp(row_sum(mask), min=1.0)
    floor = torch.maximum(row_sum(d_res * mask) / n_sup,
                          min_diag_frac * row_sum(diag0_s * mask) / n_sup)
    d = torch.where(mask > 0, torch.maximum(d_res, floor), torch.ones_like(d_res))
    r = bigl.shape[1]
    c = torch.eye(r, dtype=bigl.dtype, device=bigl.device) + row_gram(bigl, bigl / d[:, None])
    return MaskedLowRankDiagPrecond(L=bigl, d=d, chol_c=torch.linalg.cholesky(c),
                                    mask=mask.detach())


@dataclasses.dataclass(frozen=True)
class MaskedDeflationPrecond:
    """Deflation on a padded row space: M = V diag(q) V' + tau (I - V V')
    on the support rows, the identity on padding. V's rows are zero off
    support, the complement term is masked back to the identity there, and
    the logdet counts sum(mask) - m bulk modes."""

    v: torch.Tensor  # [Np, m] orthonormal columns, zero rows off support
    q: torch.Tensor  # [m] > 0
    tau: torch.Tensor  # scalar
    mask: torch.Tensor  # [Np] 1.0 support / 0.0 padding

    def apply(self, x):
        squeeze = x.dim() == 1
        xx = x[:, None] if squeeze else x
        w = row_gram(self.v, xx)
        on = xx / self.tau + self.v @ ((1.0 / self.q - 1.0 / self.tau)[:, None] * w)
        out = torch.where(self.mask[:, None] > 0, on, xx)
        return out[:, 0] if squeeze else out

    def logdet(self):
        m = self.v.shape[1]
        return torch.sum(torch.log(self.q)) + (row_sum(self.mask) - m) * torch.log(self.tau)

    def sample(self, generator: torch.Generator, num_probes: int):
        z = self.mask[:, None] * _rademacher_rows(generator, num_probes, self.v)
        w = row_gram(self.v, z)
        return torch.sqrt(self.tau) * z + self.v @ (
            (torch.sqrt(self.q) - torch.sqrt(self.tau))[:, None] * w)

    def unit_sample(self, generator: torch.Generator, num_probes: int):
        return self.mask[:, None] * _rademacher_rows(generator, num_probes, self.v)
