"""Sampling helpers (port of ``manifold_gp_tpu.utils.sampling``). Each
draws from an explicit ``torch.Generator`` or takes the drawn tensor."""

from __future__ import annotations

from typing import Optional

import torch


def grid_uniform(generator: Optional[torch.Generator], center, la, lb=None,
                 samples: int = 1, u: Optional[torch.Tensor] = None):
    """Uniform samples [samples, 2] in the axis-aligned box centered at
    ``center`` with half-widths (la, lb); lb defaults to la. ``u``: the
    [samples, 2] uniform draw on [0, 1), else drawn from ``generator``."""
    if lb is None:
        lb = la
    if u is None:
        u = torch.rand((samples, 2), generator=generator, dtype=torch.float32,
                       device=generator.device)
    center = torch.as_tensor(center, dtype=torch.float32, device=u.device)
    half = torch.tensor([la, lb], dtype=torch.float32, device=u.device)
    lo, hi = center - half, center + half
    return lo + (hi - lo) * u


def sample_posterior(posterior, generator: Optional[torch.Generator], num_samples: int,
                     jitter: float = 1e-6, xi: Optional[torch.Tensor] = None):
    """Joint samples [num_samples, n*] from any ``Posterior`` (mean, covar)
    through a jittered dense Cholesky. For the geometric model
    ``RiemannGP.posterior_samples`` samples in feature space instead.
    ``xi``: the [n*, num_samples] standard normal draw, else drawn from
    ``generator``."""
    n = posterior.mean.shape[0]
    cov = posterior.covar + jitter * torch.eye(n, dtype=posterior.covar.dtype,
                                               device=posterior.covar.device)
    chol = torch.linalg.cholesky(cov)
    if xi is None:
        xi = torch.randn((n, num_samples), generator=generator, dtype=posterior.mean.dtype,
                         device=generator.device)
    return (posterior.mean[:, None] + chol @ xi.to(chol.device)).T
