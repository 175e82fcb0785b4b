"""Inference-engine dispatch: exact (dense Cholesky) vs stochastic (CG+SLQ)
(port of ``manifold_gp_tpu.ops.engine``).

Small operators (n <= ``cfg.max_cholesky``) are densified and factorized,
large ones go through CG and stochastic Lanczos quadrature. The stochastic
paths take their randomness from the caller: either the Rademacher probes /
one-hot indices themselves (so that two packages can share them) or an
explicit ``torch.Generator`` to draw them from.

Under a single-device model's probe role (``parallel.mesh.probe_role``)
the stochastic estimates split their probe columns over the ranks where
JAX places them (``constrain_probes``): the whole batch is drawn or passed
on every rank, each keeps its own columns, and ``logdet`` /
``average_variance`` return this rank's part: the log-det estimate over
its columns (the ranks' mean is the whole estimate), the one-hot sum over
its columns divided by the whole count (the ranks' sum is the whole
estimate). The models combine the parts (``models.riemann_gp``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import InferenceConfig
from ..parallel.mesh import constrain_probes
from ..utils.metrics import count
from .cg import cg_solve
from .slq import rademacher_probes, slq_logdet


def densify(matvec: Callable, n: int, device=None) -> torch.Tensor:
    """Materialize an operator by applying it to the identity."""
    return matvec(torch.eye(n, dtype=torch.float32, device=device))


def logdet(
    matvec: Callable,
    n: int,
    cfg: InferenceConfig,
    generator: Optional[torch.Generator] = None,
    dense: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    probes: Optional[torch.Tensor] = None,
    device=None,
):
    """log det of the SPD operator, whose vectors live on ``device``. Exact (Cholesky) when n <= max_cholesky
    or a densified matrix is supplied; SLQ otherwise, with ``probes``
    ([n, num_probes] Rademacher) or probes drawn from ``generator``.
    ``precond`` (M^{-1} matvec) accelerates the SLQ gradient's CG solves."""
    if dense is None and n <= cfg.max_cholesky:
        dense = densify(matvec, n, device=device)
    if dense is not None:
        chol = torch.linalg.cholesky(dense)
        return 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    if probes is None:
        if generator is None:
            raise ValueError("stochastic logdet needs probes or a torch.Generator")
        probes = rademacher_probes(generator, n, cfg.num_probes, device=device)
    probes = constrain_probes(probes)
    return slq_logdet(
        matvec,
        probes,
        num_steps=cfg.lanczos_max_iter,
        cg_tol=cfg.cg_tolerance,
        cg_max_iter=cfg.cg_max_iter,
        precond=precond,
    )


def solve(
    matvec: Callable,
    b: torch.Tensor,
    n: int,
    cfg: InferenceConfig,
    dense: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    log_label: Optional[str] = None,
):
    """A^{-1} b, differentiable in both regimes (Cholesky AD / implicit CG);
    ``log_label`` labels the CG solves (``ops.cg``)."""
    if dense is None and n <= cfg.max_cholesky:
        dense = densify(matvec, n, device=b.device)
    if dense is not None:
        chol = torch.linalg.cholesky(dense)
        squeeze = b.dim() == 1
        x = torch.cholesky_solve(b[:, None] if squeeze else b, chol)
        return x[:, 0] if squeeze else x
    return cg_solve(
        matvec, b, tol=cfg.cg_tolerance, max_iter=cfg.cg_max_iter,
        precond=precond, log_label=log_label,
    )


def inv_quad(
    matvec: Callable,
    rhs: torch.Tensor,
    n: int,
    cfg: InferenceConfig,
    dense: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    log_label: Optional[str] = None,
):
    """sum_i rhs_i' A^{-1} rhs_i."""
    x = solve(matvec, rhs, n, cfg, dense=dense, precond=precond, log_label=log_label)
    return torch.sum(rhs * x)


def average_variance(
    matvec: Callable,
    n: int,
    num_rand_vec: int,
    cfg: InferenceConfig,
    generator: Optional[torch.Generator] = None,
    precond: Optional[Callable] = None,
    idx: Optional[torch.Tensor] = None,
    device=None,
):
    """Mean diagonal of A^{-1}, estimated with random one-hot probes: exact
    mean of the full diagonal when num_rand_vec >= n, otherwise the average
    over ``num_rand_vec`` uniformly sampled coordinates (``idx``, or drawn
    from ``generator``); the operator's vectors live on ``device``. Used for the outputscale normalization protocol in
    training."""
    if num_rand_vec >= n:
        rhs = torch.eye(n, dtype=torch.float32, device=device)
        denom = n
    else:
        if idx is None:
            if generator is None:
                raise ValueError("average_variance needs idx or a torch.Generator")
            idx = torch.randint(0, n, (num_rand_vec,), generator=generator,
                                device=generator.device)
        if not isinstance(idx, torch.Tensor):
            idx = torch.tensor(np.asarray(idx))
        idx = idx.to(device=device, dtype=torch.int64)
        rhs = torch.zeros((n, num_rand_vec), dtype=torch.float32, device=device)
        count("host_sync.avg_var.onehot")  # the scalar 1.0 is copied from the host
        rhs[idx, torch.arange(num_rand_vec, device=device)] = 1.0
        rhs = constrain_probes(rhs)
        denom = num_rand_vec
    return inv_quad(matvec, rhs, n, cfg, precond=precond, log_label="avg_var") / denom
