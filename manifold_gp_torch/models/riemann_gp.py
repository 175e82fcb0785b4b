"""Implicit-manifold GP regression model, prediction side (port of
``manifold_gp_tpu.models.riemann_gp``, supervised).

Prediction uses the exact feature-space (Woodbury) posterior: with
K = s Z Z' + sigma^2 I and C = (sigma^2/s) I_m + Z'Z,
    mean_* = mu + Z_* C^{-1} Z'(y - mu)
    cov_** = sigma^2 Z_* C^{-1} Z_*'  (+ sigma^2 I when noisy)
— only m x m dense work (m = num_modes).

Not ported yet: the semisupervised ``labeled`` mask, LOVE variances, the
blend with a vanilla GP (``base_model``) and the training-side precision
operator and loss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, InferenceConfig
from ..ops.bump import bump_function
from ..parameters import ConstrainedParam, GreaterThan, Positive


@dataclasses.dataclass
class Posterior:
    """Evaluated posterior at a set of query points."""

    mean: torch.Tensor  # [n]
    covar: torch.Tensor  # [n, n]
    stddev: torch.Tensor  # [n]


class RiemannGP:
    def __init__(
        self,
        train_x,
        train_y,
        kernel,
        labeled=None,
        noise_constraint=None,
        use_outputscale: bool = True,
        cfg: InferenceConfig = DEFAULT_CONFIG,
    ):
        if labeled is not None:
            raise NotImplementedError(
                "RiemannGP(labeled=...): the semisupervised Schur path is not "
                "ported yet (ROADMAP queue 1, 'Semisupervised')"
            )
        self.device = kernel.device
        self.train_x = torch.as_tensor(train_x, dtype=torch.float32).to(self.device)
        self.train_y = torch.as_tensor(train_y, dtype=torch.float32).to(self.device)
        self.kernel = kernel
        self.cfg = cfg
        self.use_outputscale = use_outputscale
        self._noise_decl = ConstrainedParam(
            "noise",
            noise_constraint if noise_constraint is not None else GreaterThan(1e-8),
        )
        self._outputscale_decl = ConstrainedParam("outputscale", Positive())
        # Does train_x coincide with the kernel's graph nodes? One compare at
        # construction, never per prediction call.
        self.train_is_graph = self.train_x.shape == kernel.x.shape and bool(
            torch.equal(self.train_x, kernel.x)
        )

    # -- parameters --------------------------------------------------------
    def init_params(self, noise: float = None, outputscale: float = None,
                    graphbandwidth: float = None, lengthscale: float = None,
                    mean_constant: float = 0.0) -> dict:
        params = self.kernel.init_params(graphbandwidth=graphbandwidth,
                                         lengthscale=lengthscale)
        params["raw_noise"] = self._noise_decl.init_raw(noise, device=self.device)
        if self.use_outputscale:
            params["raw_outputscale"] = self._outputscale_decl.init_raw(
                outputscale, device=self.device
            )
        params["mean_constant"] = torch.as_tensor(
            mean_constant, dtype=torch.float32, device=self.device
        )
        return params

    def noise(self, params):
        return self._noise_decl.value(params)

    def outputscale(self, params):
        return self._outputscale_decl.value(params)

    def set_outputscale(self, params: dict, value) -> dict:
        out = dict(params)
        out["raw_outputscale"] = self._outputscale_decl.constraint.inverse_transform(
            torch.as_tensor(value, dtype=torch.float32, device=self.device)
        )
        return out

    # -- prediction --------------------------------------------------------
    @torch.no_grad()
    def eval(self, params, love_rank: Optional[int] = None):
        """Precompute the spectral basis + feature-space posterior cache."""
        if love_rank is not None:
            raise NotImplementedError(
                "RiemannGP.eval(love_rank=...): LOVE variances are not ported yet"
            )
        basis = self.kernel.eval_basis(params)
        if self.train_is_graph:
            z = self.kernel.features_train(params, basis)
        else:
            z = self.kernel.features_test(params, basis, self.train_x)
        s = (
            self.outputscale(params).reshape(())
            if self.use_outputscale
            else torch.ones((), device=self.device)
        )
        sigma2 = self.noise(params).reshape(())
        mu = params["mean_constant"]
        g = z.T @ z
        m = g.shape[0]
        c = (sigma2 / s) * torch.eye(m, dtype=g.dtype, device=g.device) + g
        chol_c = torch.linalg.cholesky(c)
        resid = self.train_y - mu
        u = z.T @ resid[:, None]
        w = torch.cholesky_solve(u, chol_c)[:, 0]
        self._cache = dict(basis=basis, chol_c=chol_c, w=w, s=s, sigma2=sigma2, mu=mu)
        return self

    @torch.no_grad()
    def modulation(self, params, x):
        """bump(distance to nearest training graph point)."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        d, _ = self.kernel.knn.search(x, 1, self_query=False)
        gb = self.kernel.graphbandwidth(params).reshape(())
        return bump_function(
            torch.sqrt(d[:, 0]), self.kernel.bump_scale * gb, self.kernel.bump_decay
        )

    @torch.no_grad()
    def posterior(self, params, x, noisy_posterior: bool = False, base_model=None,
                  base_params=None, is_train: Optional[bool] = None) -> Posterior:
        """Geometric posterior at ``x``; ``is_train=True`` forces the
        in-sample feature path."""
        if base_model is not None:
            raise NotImplementedError(
                "RiemannGP.posterior(base_model=...): the vanilla-GP blend is "
                "not ported yet (ROADMAP queue 1, 'Vanilla baseline')"
            )
        cache = self._cache
        zs = self.kernel.features(params, cache["basis"], x, is_train=is_train)
        mean = cache["mu"] + (zs @ cache["w"][:, None])[:, 0]
        half = torch.linalg.solve_triangular(cache["chol_c"], zs.T, upper=False)
        covar = cache["sigma2"] * (half.T @ half)
        if noisy_posterior:
            covar = covar + cache["sigma2"] * torch.eye(
                covar.shape[0], dtype=covar.dtype, device=covar.device
            )
        stddev = torch.sqrt(torch.clamp(torch.diagonal(covar), min=0.0))
        return Posterior(mean=mean, covar=covar, stddev=stddev)
