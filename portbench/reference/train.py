"""The training estimator in float64: the outputscale normalization, the
precision-form marginal likelihood by stochastic Lanczos quadrature on the
given probes, its Hutchinson gradient, and Adam steps.

  loss = 0.5 (y' Qn y - logdet Qn + n log 2 pi) / n
  logdet Qn ~ (n / p) sum_i e1' log(T_i) e1     (m Lanczos steps from z_i)
  d logdet  ~ (1 / p) sum_i (Qn^-1 z_i)' dQn z_i

Solves are Jacobi-preconditioned CG to ten times tighter than the
configuration's tolerance (``SOLVE_TOL_FACTOR``), the normalization's one-hot
solves a thousand times tighter.
"""

from __future__ import annotations

import math

import torch

from .operator import Precision, values

SOLVE_TOL_FACTOR = 0.1  # the reference's CG tolerance, per the config's


def cg(apply, b: torch.Tensor, diag: torch.Tensor, tol: float, max_iter: int):
    """Jacobi-preconditioned CG on every column of b until each residual is
    below tol times its column's norm (converged columns stop moving)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r / diag[:, None]
    p = z
    rz = torch.sum(r * z, dim=0)
    stop = tol * tol * torch.sum(b * b, dim=0)
    for it in range(max_iter):
        rs = torch.sum(r * r, dim=0)
        active = rs > stop
        if not bool(active.any()):
            return x, it
        ap = apply(p)
        alpha = torch.where(active, rz / torch.sum(p * ap, dim=0), torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * ap
        z = r / diag[:, None]
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(active, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = torch.where(active, rz_new, rz)
    return x, max_iter


def slq_logdet(apply, probes: torch.Tensor, steps: int) -> torch.Tensor:
    """(n / p) sum_i e1' log(T_i) e1 over m-step Lanczos tridiagonalizations
    started at each normalized probe (no reorthogonalization; a column that
    breaks down is closed with an identity block)."""
    n = probes.shape[0]
    q = probes / torch.linalg.norm(probes, dim=0)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(q.shape[1], dtype=q.dtype, device=q.device)
    alive = torch.ones(q.shape[1], dtype=torch.bool, device=q.device)
    alphas, betas, valid = [], [], []
    for _ in range(min(steps, n)):
        w = apply(q)
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha * q - beta_prev * q_prev
        beta = torch.linalg.norm(w, dim=0)
        alive_next = alive & (beta > 1e-10)
        q_next = torch.where(alive_next, w / torch.where(alive_next, beta, 1.0), 0.0)
        beta = torch.where(alive_next, beta, 0.0)
        alphas.append(alpha)
        betas.append(beta)
        valid.append(alive)
        q_prev, q, beta_prev, alive = q, q_next, beta, alive_next
    a = torch.where(torch.stack(valid), torch.stack(alphas), 1.0).T
    b = torch.where(torch.stack(valid)[1:], torch.stack(betas)[:-1], 0.0).T
    t = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    lam, vec = torch.linalg.eigh(t)
    quad = torch.sum(vec[:, 0, :] ** 2 * torch.log(torch.clamp(lam, min=1e-300)), dim=1)
    return n * torch.mean(quad)


class Problem:
    """One training problem: the graph, labels, floor and configuration."""

    def __init__(self, graph, y: torch.Tensor, gb_floor: float, nu: int, inference: dict,
                 precision: str = "f64"):
        self.graph, self.y, self.gb_floor, self.nu = graph, y, gb_floor, nu
        self.inference = inference
        self.steps = int(inference["lanczos_max_iter"])
        self.tol = float(inference["cg_tolerance"]) * SOLVE_TOL_FACTOR
        self.max_iter = 4 * int(inference["cg_max_iter"])
        self.precision = precision

    def op(self, raw, differentiable=False):
        return Precision(self.graph, raw, self.gb_floor, self.nu, self.precision,
                         differentiable)

    @torch.no_grad()
    def average_variance(self, raw: dict, idx: torch.Tensor) -> torch.Tensor:
        """mean_i (Q^-1)_ii over ``idx``, Q the unscaled kernel precision."""
        op = self.op(raw)
        rhs = torch.zeros((self.graph.n, idx.shape[0]), dtype=torch.float64,
                          device=self.y.device)
        rhs[idx, torch.arange(idx.shape[0], device=idx.device)] = 1.0
        x, _ = cg(op.kernel_q, rhs, op.kernel_q_diag(), self.tol * 1e-2, self.max_iter)
        return torch.sum(rhs * x) / idx.shape[0]

    def normalized_outputscale(self, raw: dict, idx) -> float:
        """The outputscale after the normalization that opens a job."""
        vals = values(raw, self.gb_floor)
        return float(vals["outputscale"] / self.average_variance(raw, idx))

    @torch.no_grad()
    def loss(self, raw: dict, probes: torch.Tensor) -> float:
        op = self.op(raw)
        y = self.y[:, None]
        n = self.graph.n
        quad = torch.sum(y * op(y))
        ld = slq_logdet(op, probes, self.steps)
        return float(0.5 * (quad - ld + n * math.log(2.0 * math.pi)) / n)

    def loss_and_grad(self, raw: dict, probes: torch.Tensor, chunk: int = 16):
        """(loss, {leaf: gradient}) at ``raw`` (float64 leaves)."""
        n = self.graph.n
        loss = self.loss(raw, probes)
        with torch.no_grad():
            op = self.op(raw)
            solves, _ = cg(op, probes, op.diag(), self.tol, self.max_iter)
        leaves = {k: v.detach().clone().requires_grad_(k != "mean_constant")
                  for k, v in raw.items()}
        wanted = [leaves[k] for k in leaves if k != "mean_constant"]
        grads = [torch.zeros_like(w) for w in wanted]
        y = self.y[:, None]
        pieces = [(y, y, 1.0)] + [
            (solves[:, i:i + chunk], probes[:, i:i + chunk], -1.0 / probes.shape[1])
            for i in range(0, probes.shape[1], chunk)]
        for left, right, weight in pieces:
            op = self.op(leaves, differentiable=True)
            term = weight * 0.5 / n * torch.sum(left * op(right))
            for acc, g in zip(grads, torch.autograd.grad(term, wanted)):
                acc += g
        out = dict(zip([k for k in leaves if k != "mean_constant"], grads))
        out["mean_constant"] = torch.zeros_like(raw["mean_constant"])
        return loss, out


def follow(problem: Problem, raw0: dict, probes_at, steps: int, lr: float):
    """The reference's own ``steps`` Adam steps from ``raw0`` with the probes
    of each step (``probes_at(step)``): (first loss-and-gradient, raw after
    the steps)."""
    leaves = {k: v.detach().clone() for k, v in raw0.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0)
    first = None
    for step in range(steps):
        loss, grads = problem.loss_and_grad(leaves, probes_at(step))
        if first is None:
            first = (loss, {k: g.clone() for k, g in grads.items()})
        for k, v in leaves.items():
            v.grad = grads[k]
        opt.step()
    return first, leaves
