"""Stochastic Lanczos quadrature (SLQ) log-determinant with unbiased gradient
(port of ``manifold_gp_tpu.ops.slq``).

Value:  tr(log Q) ~= (n / p) * sum_i  e1' log(T_i) e1
        with T_i the m-step Lanczos tridiagonalization of Q started at the
        i-th normalized Rademacher probe (||z||^2 = n).
Gradient (custom backward, the Hutchinson trace identity):
        d tr(log Q) / d theta = E_z[ z' Q^{-1} (dQ/dtheta) z ]
        estimated with the same probes; the solves Q^{-1} z are CG solves
        performed in the backward pass only (no differentiation through the
        Lanczos recurrence).

All probes advance together — each Lanczos step is one [N, P] matvec — and
the P tridiagonal matrices go through one batched ``torch.linalg.eigh``.

The preconditioned quadrature (``slq_logdet_mbcg``, GPyTorch's mBCG
log-det) draws its probes from the preconditioner M, reads the
tridiagonalization of M^{-1/2} Q M^{-1/2} off a fixed number of PCG steps
(``pcg_tridiag_batched``) and adds log det M.

Row-sharded operators (``parallel``): the probes are this rank's rows of
support-embedded global probes, every sum over rows is
``parallel.mesh.row_sum``, and the trace dimension is the true node count
(``num_nodes``); the Functions re-enter their forward's mesh context in the
backward. Split probe columns (the probe role of ``parallel.mesh``) need
nothing here: each rank's estimate and its implicit VJP are those of its
own columns, and the model sums the ranks' shares.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel.mesh import active_context, row_sum, use_context
from ..utils.metrics import count, span
from .cg import cg_raw, consts_cotangents
from .operator import as_operator

_BREAKDOWN_TOL = 1e-10


def lanczos_batched(matvec: Callable, q0: torch.Tensor, num_steps: int):
    """m-step Lanczos without reorthogonalization, batched over columns.

    Args:
      matvec: symmetric linear map [N, P] -> [N, P].
      q0: [N, P] unit-norm start vectors.
      num_steps: m.
    Returns:
      alphas [m, P], betas [m, P] (betas[j] couples step j and j+1; the last
      row is unused), valid [m, P] (False after a breakdown).
    """
    n, p = q0.shape
    num_steps = min(num_steps, n)
    q_prev = torch.zeros_like(q0)
    q = q0
    beta_prev = torch.zeros((p,), dtype=q0.dtype, device=q0.device)
    alive = torch.ones((p,), dtype=torch.bool, device=q0.device)
    alphas, betas, valid = [], [], []
    for _ in range(num_steps):
        with span("imgp.lanczos.step"):
            with span("imgp.operator.apply"):
                w = matvec(q)
            alpha = row_sum(q * w, dim=0)
            w = w - alpha[None, :] * q - beta_prev[None, :] * q_prev
            beta = torch.sqrt(row_sum(w * w, dim=0))
            alive_next = alive & (beta > _BREAKDOWN_TOL)
            safe_beta = torch.where(alive_next, beta, torch.ones_like(beta))
            q_next = torch.where(alive_next[None, :], w / safe_beta[None, :],
                                 torch.zeros_like(w))
            beta_out = torch.where(alive_next, beta, torch.zeros_like(beta))
            alphas.append(alpha)
            betas.append(beta_out)
            valid.append(alive)
            q_prev, q, beta_prev, alive = q, q_next, beta_out, alive_next
    return torch.stack(alphas), torch.stack(betas), torch.stack(valid)


def _tridiag_e1_quadrature(alphas, betas, valid, f):
    """Per-probe Gauss quadrature e1' f(T) e1 from Lanczos coefficients.

    alphas/betas/valid: [m, P]. Steps after a breakdown are replaced by an
    identity block (it decouples from the leading one, so estimates stay
    exact for graphs whose Krylov space is exhausted early).
    """
    a = torch.where(valid, alphas, torch.ones_like(alphas)).T  # [P, m]
    b = torch.where(valid[1:], betas[:-1], torch.zeros_like(betas[:-1])).T  # [P, m-1]
    t = torch.diag_embed(a) + torch.diag_embed(b, offset=1) + torch.diag_embed(b, offset=-1)
    count("host_sync.eigh.slq")  # eigh checks its info on the host
    evals, evecs = torch.linalg.eigh(t)
    w = evecs[:, 0, :] ** 2
    return torch.sum(w * f(evals), dim=1)


def slq_logdet_raw(matvec, probes, num_steps: int, num_nodes: Optional[int] = None):
    """Forward SLQ estimate of log det Q. probes: [N, P] Rademacher.

    ``num_nodes``: Hutchinson trace dimension; defaults to the probe length.
    Pass the true node count when probes are zero-padded."""
    n = probes.shape[0] if num_nodes is None else num_nodes
    q0 = probes / torch.sqrt(row_sum(probes * probes, dim=0))[None, :]
    alphas, betas, valid = lanczos_batched(matvec, q0, num_steps)
    quad = _tridiag_e1_quadrature(
        alphas, betas, valid, lambda lam: torch.log(torch.clamp(lam, min=1e-20))
    )
    return n * torch.mean(quad)


class _SLQLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, precond, num_steps, cg_tol, cg_max_iter, num_nodes, probes, *consts):
        ctx.fn, ctx.precond = fn, precond
        ctx.cg_tol, ctx.cg_max_iter = cg_tol, cg_max_iter
        ctx.sharding = active_context()
        ctx.save_for_backward(probes, *consts)
        return slq_logdet_raw(lambda v: fn(v, *consts), probes, num_steps, num_nodes=num_nodes)

    @staticmethod
    def backward(ctx, g):
        probes, *consts = ctx.saved_tensors
        fn = ctx.fn
        p = probes.shape[1]
        with use_context(ctx.sharding):
            solves = cg_raw(lambda v: fn(v, *consts), probes, ctx.cg_tol, ctx.cg_max_iter,
                            precond=ctx.precond, log_label="slq_grad")
            # d logdet = (1/p) sum_i (Q^{-1} z_i)' dQ z_i
            bars = consts_cotangents(fn, probes, consts, ctx.needs_input_grad[7:],
                                     solves * (g / p))
        return (None, None, None, None, None, None, None, *bars)


def slq_logdet(
    matvec,
    probes: torch.Tensor,
    num_steps: int,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 1000,
    precond: Optional[Callable] = None,
    num_nodes: Optional[int] = None,
):
    """Stochastic log det of the SPD operator behind ``matvec``.

    Differentiable w.r.t. the tensors of ``matvec`` (an ``Operator``):
    unbiased Hutchinson gradient; the probes themselves get none.

    ``precond``: optional M^{-1} matvec for the backward CG solves (the
    forward Lanczos quadrature stays unpreconditioned).
    ``num_nodes``: true trace dimension when the probes live in a padded
    space with zeroed padding rows.
    """
    op = as_operator(matvec)
    return _SLQLogdet.apply(
        op.fn, precond, int(num_steps), float(cg_tol), int(cg_max_iter),
        None if num_nodes is None else int(num_nodes), probes, *op.consts,
    )


def rademacher_probes(generator: torch.Generator, n: int, num_probes: int,
                      dtype=torch.float32, device=None):
    """[n, num_probes] of +-1 drawn from ``generator`` (on its device), moved
    to ``device`` (default: the generator's)."""
    bits = torch.randint(0, 2, (n, num_probes), generator=generator, device=generator.device)
    probes = (2 * bits - 1).to(dtype)
    return probes if device is None else probes.to(device)


# ---------------------------------------------------------------------------
# Preconditioned SLQ (mBCG semantics)
# ---------------------------------------------------------------------------


def pcg_tridiag_batched(matvec: Callable, minv: Callable, b: torch.Tensor, num_steps: int):
    """Preconditioned-CG coefficient extraction, batched over RHS columns.

    Runs ``num_steps`` of PCG on A x = b with preconditioner M^{-1} and
    records the (alpha_k, beta_k) recurrence coefficients. The CG-Lanczos
    identity turns them into the tridiagonalization T of
    B = M^{-1/2} A M^{-1/2} in the Krylov basis started at
    M^{-1/2} b / ||M^{-1/2} b||. A fixed number of steps and no stop test:
    a column that breaks down is masked (``valid``), never read on the host.

    Returns (alphas [m, P], betas [m, P], valid [m, P]).
    """
    n, p = b.shape
    num_steps = min(num_steps, n)
    r = b
    z = minv(b)
    pvec = z
    rz = row_sum(b * z, dim=0)
    alive = torch.ones((p,), dtype=torch.bool, device=b.device)
    one = torch.ones_like(rz)
    alphas, betas, valid = [], [], []
    for _ in range(num_steps):
        ap = matvec(pvec)
        pap = row_sum(pvec * ap, dim=0)
        alive_now = alive & (rz > 1e-30) & (pap > 0.0)
        alpha = torch.where(alive_now, rz / torch.where(alive_now, pap, one), one)
        r = r - alpha[None, :] * ap
        z = minv(r)
        rz_new = row_sum(r * z, dim=0)
        rel = rz_new / torch.where(rz == 0, one, rz)
        beta = torch.where(alive_now, torch.clamp(rel, min=0.0), torch.zeros_like(rel))
        alive = alive_now & (rz_new > 1e-30)
        pvec = z + beta[None, :] * pvec
        rz = torch.where(alive, rz_new, rz)
        alphas.append(alpha)
        betas.append(beta)
        valid.append(alive_now)
    return torch.stack(alphas), torch.stack(betas), torch.stack(valid)


def _pcg_t_quadrature(alphas, betas, valid, f):
    """e1' f(T) e1 per probe from PCG coefficients:
    T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1},  T[k,k+1] = sqrt(beta_k)/alpha_k.
    Steps after a breakdown become decoupled identity blocks, as in
    ``_tridiag_e1_quadrature``. One batched ``eigh`` over the P matrices."""
    a, bt, v = alphas.T, betas.T, valid.T  # [P, m]
    safe_a = torch.where(v, a, torch.ones_like(a))
    diag = 1.0 / safe_a
    carry = torch.where(v[:, :-1], bt[:, :-1] / safe_a[:, :-1], torch.zeros_like(safe_a[:, :-1]))
    diag = diag + torch.nn.functional.pad(carry, (1, 0))
    diag = torch.where(v, diag, torch.ones_like(diag))
    off = torch.where(
        v[:, :-1] & v[:, 1:],
        torch.sqrt(torch.clamp(bt[:, :-1], min=0.0)) / safe_a[:, :-1],
        torch.zeros_like(safe_a[:, :-1]),
    )
    t = torch.diag_embed(diag) + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)
    count("host_sync.eigh.mbcg")  # eigh checks its info on the host
    evals, evecs = torch.linalg.eigh(t)
    w = evecs[:, 0, :] ** 2
    return torch.sum(w * f(evals), dim=1)


class _SLQMbcg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, minv, num_steps, cg_tol, cg_max_iter, zm, zr, mlogdet, *consts):
        ctx.fn, ctx.minv = fn, minv
        ctx.cg_tol, ctx.cg_max_iter = cg_tol, cg_max_iter
        ctx.sharding = active_context()
        ctx.save_for_backward(zr, *consts)
        gamma = row_sum(zm * minv(zm), dim=0)  # ||M^{-1/2} z||^2 per probe
        alphas, betas, valid = pcg_tridiag_batched(lambda v: fn(v, *consts), minv, zm, num_steps)
        quad = _pcg_t_quadrature(alphas, betas, valid,
                                 lambda lam: torch.log(torch.clamp(lam, min=1e-20)))
        return mlogdet + torch.mean(gamma * quad)

    @staticmethod
    def backward(ctx, g):
        zr, *consts = ctx.saved_tensors
        fn = ctx.fn
        p = zr.shape[1]
        with use_context(ctx.sharding):
            solves = cg_raw(lambda v: fn(v, *consts), zr, ctx.cg_tol, ctx.cg_max_iter,
                            precond=ctx.minv, log_label="mbcg_grad")
            # d logdet(A) = (1/p) sum_i (A^{-1} z_i)' dA z_i with E[z z'] = I;
            # the preconditioner (and its logdet, which only recenters the
            # estimator) gets no gradient.
            bars = consts_cotangents(fn, zr, consts, ctx.needs_input_grad[8:],
                                     solves * (g / p))
        return (None,) * 8 + tuple(bars)


def slq_logdet_mbcg(
    matvec,
    precond,
    generator: Optional[torch.Generator],
    num_probes: Optional[int],
    num_steps: int,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 1000,
    probes=None,
):
    """Preconditioned stochastic Lanczos quadrature (GPyTorch's mBCG
    log-det semantics, Gardner et al. 2018):

        logdet(A) = logdet(M) + tr log(M^{-1/2} A M^{-1/2})
                  ~= M.logdet() + mean_i [ z_i' M^{-1} z_i * e1' log(T_i) e1 ]

    with probes z_i (E[zz'] = M) and T_i the PCG-coefficient
    tridiagonalization.

    ``precond``: an ``ops.pivchol`` object (``apply`` / ``sample`` /
    ``unit_sample`` / ``logdet``). ``probes``: the pair (zm, zr) of
    quadrature probes (E[zz'] = M) and gradient probes (E[zz'] = I), each
    [n, P]; else both are drawn from ``generator`` (``precond.sample``, then
    ``precond.unit_sample``, ``num_probes`` each).

    Differentiable w.r.t. the tensors of ``matvec`` (an ``Operator``):
    unbiased Hutchinson gradient on the plain probes zr, solved with
    M-preconditioned CG; the preconditioner gets no gradient.
    """
    if probes is None:
        if generator is None:
            raise ValueError("stochastic logdet needs probes or a torch.Generator")
        probes = (precond.sample(generator, num_probes),
                  precond.unit_sample(generator, num_probes))
    zm, zr = probes
    op = as_operator(matvec)
    with torch.no_grad():
        mlogdet = precond.logdet()
    return _SLQMbcg.apply(
        op.fn, precond.apply, int(num_steps), float(cg_tol), int(cg_max_iter),
        zm.detach(), zr.detach(), mlogdet, *op.consts,
    )
