"""Model evaluation: RMSE and negative log predictive density (port of
``manifold_gp_tpu.utils.evaluate``).

  rmse = sqrt(mean((y - posterior_mean)^2))
  nll  = 0.5 [ e' Sigma^{-1} e + logdet Sigma + n log 2pi ] / n

on the (noisy) posterior covariance: exactly, by dense Cholesky of the test
block (the default), or as the reference computes it, stochastically
(``gaussian_nll_stochastic``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def gaussian_nll(error, covar):
    n = error.shape[0]
    chol = torch.linalg.cholesky(covar)
    alpha = torch.cholesky_solve(error[:, None], chol)[:, 0]
    inv_quad = torch.dot(error, alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * (inv_quad + logdet + n * math.log(2.0 * math.pi)) / n


def gaussian_nll_stochastic(error, covar, generator: Optional[torch.Generator] = None,
                            num_probes: int = 10, lanczos_steps: int = 20,
                            cg_tol: float = 1e-2, cg_max_iter: int = 1000,
                            jitter: float = 1e-4, probes: Optional[torch.Tensor] = None):
    """The reference's NLL metric, stochastic as the reference computes it
    (GPyTorch's ``inv_quad_logdet`` above ``max_cholesky_size``): the
    inv_quad by CG at ``cg_tol`` and the log-det by stochastic Lanczos
    quadrature with ``num_probes`` Rademacher probes and ``lanczos_steps``
    steps, on the covariance plus ``jitter`` times its mean diagonal.
    ``probes``: the [n, num_probes] Rademacher draw, else drawn from
    ``generator``."""
    from ..ops.cg import cg_raw
    from ..ops.slq import rademacher_probes, slq_logdet_raw

    n = error.shape[0]
    jit_val = jitter * torch.mean(torch.diagonal(covar))
    cov_j = covar + jit_val * torch.eye(n, dtype=covar.dtype, device=covar.device)

    def matvec(v):
        return cov_j @ v

    alpha = cg_raw(matvec, error[:, None], cg_tol, cg_max_iter)[:, 0]
    inv_quad = torch.dot(error, alpha)
    if probes is None:
        probes = rademacher_probes(generator, n, num_probes, device=covar.device)
    logdet = slq_logdet_raw(matvec, probes.to(covar.device), lanczos_steps)
    return 0.5 * (inv_quad + logdet + n * math.log(2.0 * math.pi)) / n


@torch.no_grad()
def test_model(model, params, test_x, test_y, noisy_test: bool = False,
               base_model=None, base_params=None, metric: str = "exact",
               generator: Optional[torch.Generator] = None,
               probes: Optional[torch.Tensor] = None):
    """Returns (rmse, nll) floats.

    ``base_model`` / ``base_params``: a vanilla GP to blend in away from the
    manifold (``RiemannGP.posterior``); it is evaluated here too.
    ``metric``: "exact" (dense Cholesky NLL, the default) or "reference"
    (the reference's stochastic metric, ``gaussian_nll_stochastic``, at its
    defaults; needs ``generator`` or ``probes``)."""
    if metric == "reference" and generator is None and probes is None:
        raise ValueError("the reference metric is stochastic: pass a generator or probes")
    model.eval(params)
    if base_model is not None:
        base_model.eval(base_params)
        post = model.posterior(params, test_x, noisy_posterior=noisy_test,
                               base_model=base_model, base_params=base_params)
    else:
        # a VanillaGP's posterior takes no base model (as in the JAX package)
        post = model.posterior(params, test_x, noisy_posterior=noisy_test)
    test_y = torch.as_tensor(test_y, dtype=torch.float32).to(post.mean.device)
    error = test_y - post.mean
    rmse = torch.sqrt(torch.mean(error * error))
    if metric == "reference":
        nll = gaussian_nll_stochastic(error, post.covar, generator, probes=probes)
    else:
        nll = gaussian_nll(error, post.covar)
    return float(rmse), float(nll)
