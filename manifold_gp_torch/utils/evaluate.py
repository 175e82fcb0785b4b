"""Model evaluation: RMSE and negative log predictive density (port of the
exact metric of ``manifold_gp_tpu.utils.evaluate``).

  rmse = sqrt(mean((y - posterior_mean)^2))
  nll  = 0.5 [ e' Sigma^{-1} e + logdet Sigma + n log 2pi ] / n

on the (noisy) posterior covariance, by dense Cholesky of the test block.
"""

from __future__ import annotations

import math

import torch


def gaussian_nll(error, covar):
    n = error.shape[0]
    chol = torch.linalg.cholesky(covar)
    alpha = torch.cholesky_solve(error[:, None], chol)[:, 0]
    inv_quad = torch.dot(error, alpha)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * (inv_quad + logdet + n * math.log(2.0 * math.pi)) / n


@torch.no_grad()
def test_model(model, params, test_x, test_y, noisy_test: bool = False,
               base_model=None, base_params=None, metric: str = "exact"):
    """Returns (rmse, nll) floats. Only the exact metric is ported; the
    stochastic reference metric and the vanilla blend raise."""
    if metric != "exact":
        raise NotImplementedError(
            "test_model(metric='reference'): the stochastic mBCG metric needs "
            "the CG/SLQ stack of the training slice"
        )
    if base_model is not None:
        raise NotImplementedError("test_model(base_model=...): not ported yet")
    model.eval(params)
    post = model.posterior(params, test_x, noisy_posterior=noisy_test)
    test_y = torch.as_tensor(test_y, dtype=torch.float32).to(post.mean.device)
    error = test_y - post.mean
    rmse = torch.sqrt(torch.mean(error * error))
    nll = gaussian_nll(error, post.covar)
    return float(rmse), float(nll)
