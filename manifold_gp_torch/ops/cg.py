"""Batched (preconditioned) conjugate gradients with implicit differentiation
(port of ``manifold_gp_tpu.ops.cg``).

  * one loop drives all right-hand sides jointly (multi-RHS CG shares every
    matvec);
  * gradients do NOT backprop through the Krylov iterations. ``cg_solve`` is
    a ``torch.autograd.Function`` with the implicit-function backward: for
    x = A(theta)^{-1} b,
      bar_b     = A^{-1} bar_x          (one adjoint CG solve; A symmetric)
      bar_theta = -vjp_theta(A(theta) x)(bar_b)
    The preconditioner only changes the iteration path, never the solution,
    so what it captures receives no gradient.

The operator arrives as an ``ops.operator.Operator`` (its matvec plus the
tensors it depends on); the backward recomputes ``A x`` under
``torch.enable_grad()`` on detached copies of those tensors and asks autograd
for their cotangents.

The stop test reads one boolean from the device per iteration (a host
synchronisation each), so that iteration counts equal the JAX package's.

``iteration_log``: set it to a list and every ``cg_raw`` call appends
(label, rows, columns, iterations) to it (None, the default, records
nothing). ``label`` is the caller's ``log_label``, None unless given: the
Schur operator's inner solves (``ops.matern.make_schur_matvec``) pass
"schur_inner", forward and adjoint alike.

Row-sharded operators (``parallel``): every sum over rows is
``parallel.mesh.row_sum``, which all-reduces under a mesh context and is
``torch.sum`` without one; the solve's Function captures the context in its
forward and re-enters it in its backward, so the stop test reads a reduced
value and every rank takes the same branch. In the probe role (a
single-device model's probe columns split over the ranks) the sums are
local and so is the stop test: a column's value does not depend on when
the loop stops, since converged columns are frozen, so the ranks need not
agree on an iteration count.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import active_context, row_sum, use_context
from .operator import as_operator

iteration_log: Optional[list] = None


@torch.no_grad()
def cg_raw(
    matvec: Callable,
    b: torch.Tensor,
    tol: float,
    max_iter: int,
    x0=None,
    precond: Optional[Callable] = None,
    with_info: bool = False,
    log_label: Optional[str] = None,
):
    """Plain batched (P)CG (no gradient). b: [N] or [N, B].

    Terminates when every column's residual norm drops below
    ``tol * ||b_col||`` or at ``max_iter``. Converged columns are frozen to
    avoid roundoff drift.

    ``precond``: optional SPD M^{-1} matvec (e.g. Jacobi: v / diag(A));
    termination still measures the true residual, so tolerances mean the
    same thing with and without preconditioning.
    ``with_info``: also return the iteration count (a Python int).
    ``log_label``: the label of this solve's ``iteration_log`` entry.
    """
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    b_norm2 = row_sum(b * b, dim=0)
    # Guard all-zero columns (solution 0).
    stop2 = (tol * tol) * torch.clamp(b_norm2, min=1e-30)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - matvec(x)
    z = r if precond is None else precond(r)
    p = z
    rs = row_sum(r * r, dim=0)
    rz = rs if precond is None else row_sum(r * z, dim=0)
    zero = torch.zeros_like(rs)
    one = torch.ones_like(rs)

    iters = 0
    while iters < max_iter and bool(torch.any(rs > stop2)):
        ap = matvec(p)
        pap = row_sum(p * ap, dim=0)
        active = rs > stop2
        alpha = torch.where(active, rz / torch.where(pap == 0, one, pap), zero)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        rs_new = row_sum(r * r, dim=0)
        if precond is None:
            z, rz_new = r, rs_new
        else:
            z = precond(r)
            rz_new = row_sum(r * z, dim=0)
        beta = torch.where(active, rz_new / torch.where(rz == 0, one, rz), zero)
        p = z + beta[None, :] * p
        rs = torch.where(active, rs_new, rs)
        rz = torch.where(active, rz_new, rz)
        iters += 1
    if iteration_log is not None:
        iteration_log.append((log_label, b.shape[0], b.shape[1], iters))
    x_out = x[:, 0] if squeeze else x
    return (x_out, iters) if with_info else x_out


def consts_cotangents(fn, x, consts, needs, weight):
    """Cotangents of ``consts`` for ``sum(weight * fn(x, *consts))``, for the
    entries of ``consts`` flagged in ``needs`` (None elsewhere): recomputes
    the matvec under grad mode on detached copies, so that custom backwards
    inside ``fn`` (the panel-cotangent kernel) run here."""
    out = [None] * len(consts)
    if not any(needs):
        return out
    with torch.enable_grad():
        cs = [c.detach().requires_grad_(need) for c, need in zip(consts, needs)]
        value = fn(x.detach(), *cs)
        wanted = [c for c in cs if c.requires_grad]
        grads = torch.autograd.grad(value, wanted, weight, allow_unused=True)
    it = iter(grads)
    return [next(it) if need else None for need in needs]


class _CGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, precond, tol, max_iter, log_label, b, *consts):
        x = cg_raw(lambda v: fn(v, *consts), b, tol, max_iter, precond=precond,
                   log_label=log_label)
        ctx.fn, ctx.precond, ctx.tol, ctx.max_iter = fn, precond, tol, max_iter
        ctx.log_label, ctx.sharding = log_label, active_context()
        ctx.save_for_backward(x, *consts)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *consts = ctx.saved_tensors
        fn = ctx.fn
        # A is symmetric for every operator in this framework.
        with use_context(ctx.sharding):
            lam = cg_raw(lambda v: fn(v, *consts), g.contiguous(), ctx.tol, ctx.max_iter,
                         precond=ctx.precond, log_label=ctx.log_label)
            bars = consts_cotangents(fn, x, consts, ctx.needs_input_grad[6:], -lam)
        return (None, None, None, None, None, lam if ctx.needs_input_grad[5] else None, *bars)


def cg_solve(
    matvec,
    b: torch.Tensor,
    tol: float = 1e-2,
    max_iter: int = 1000,
    precond: Optional[Callable] = None,
    log_label: Optional[str] = None,
):
    """Solve A x = b with (P)CG; differentiable w.r.t. ``b`` and the tensors
    of ``matvec`` (an ``Operator``; a bare callable gets gradients for ``b``
    only) via the implicit-function backward above.

    ``matvec`` must be a symmetric positive-definite linear map
    [N, B] -> [N, B] (or [N] -> [N]). ``precond`` is an optional M^{-1}
    matvec used in both the forward and the adjoint solve; ``log_label``
    labels both solves' ``iteration_log`` entries.
    """
    op = as_operator(matvec)
    return _CGSolve.apply(op.fn, precond, float(tol), int(max_iter), log_label, b, *op.consts)
