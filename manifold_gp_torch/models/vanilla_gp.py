"""Vanilla (Euclidean) exact GP baseline (port of
``manifold_gp_tpu.models.vanilla_gp``).

Constant mean, outputscale, noise (default constraint GreaterThan(1e-4),
GPyTorch's GaussianLikelihood default) over a Euclidean kernel
(``kernels.euclidean``). Two regimes, as GPyTorch runs them:

  * n <= cfg.max_cholesky: dense Cholesky of K + sigma^2 I for the marginal
    likelihood and the posterior;
  * above it, BBMM: CG for the quadratic term and the mBCG log-det
    (``ops.slq.slq_logdet_mbcg``), both under the rank-``precond_rank``
    pivoted-Cholesky preconditioner; the posterior from a CG mean cache and
    a rank-``love_rank`` LOVE root of the train covariance
    (``ops.eigen.lanczos_eigh``).

Up to ``cfg.dense_gram_max_size`` the iterative regime multiplies by a
gram made once; above it the kernel's tiled ``gram_matvec`` makes the tiles
anew each product. Randomness (probes, the LOVE start vector) is passed in
or drawn from an explicit ``torch.Generator``. Under a user's ``use_mesh``
the methods run in the probe role (``parallel.mesh.probe_role``): every sum
is local and nothing is split (JAX does not place the mBCG probes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, InferenceConfig
from ..ops.operator import Operator
from ..parallel.mesh import in_probe_role
from ..parameters import ConstrainedParam, GreaterThan, Positive
from .riemann_gp import Posterior


class VanillaGP:
    def __init__(self, train_x, train_y, kernel, noise_constraint=None,
                 cfg: InferenceConfig = DEFAULT_CONFIG):
        self.device = kernel.device
        self.train_x = torch.as_tensor(train_x, dtype=torch.float32).to(self.device)
        self.train_y = torch.as_tensor(train_y, dtype=torch.float32).to(self.device)
        self.kernel = kernel
        self.cfg = cfg
        self._noise_decl = ConstrainedParam(
            "noise",
            noise_constraint if noise_constraint is not None else GreaterThan(1e-4),
        )
        self._outputscale_decl = ConstrainedParam("outputscale", Positive())

    def init_params(self, noise: float = None, outputscale: float = None,
                    lengthscale: float = None, mean_constant: float = 0.0) -> dict:
        params = self.kernel.init_params(lengthscale=lengthscale)
        params["raw_noise"] = self._noise_decl.init_raw(noise, device=self.device)
        params["raw_outputscale"] = self._outputscale_decl.init_raw(outputscale,
                                                                    device=self.device)
        params["mean_constant"] = torch.as_tensor(mean_constant, dtype=torch.float32,
                                                  device=self.device)
        return params

    def noise(self, params):
        return self._noise_decl.value(params)

    def outputscale(self, params):
        return self._outputscale_decl.value(params)

    @property
    def num_data(self) -> int:
        return int(self.train_y.shape[0])

    def _train_covar(self, params):
        k = self.outputscale(params).reshape(()) * self.kernel.gram(params, self.train_x)
        eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
        return k + self.noise(params).reshape(()) * eye

    def _covar_matvec_and_diag(self, params):
        """(operator, diag) of K + sigma^2 I for the iterative regime: a
        gram made once up to cfg.dense_gram_max_size, the tiled
        ``gram_matvec`` above it."""
        n = self.num_data
        s = self.outputscale(params).reshape(())
        sigma2 = self.noise(params).reshape(())
        if n <= self.cfg.dense_gram_max_size:
            kmat = self._train_covar(params)
            return Operator(lambda v, k: k @ v, (kmat,)), torch.diagonal(kmat)
        x = self.train_x

        def mv(v, raw_lengthscale, s, sigma2):
            kv = self.kernel.gram_matvec({"raw_lengthscale": raw_lengthscale}, x, v)
            return s * kv + sigma2 * v

        # stationary kernels: k(0) = 1, so diag(K + sigma^2 I) = s + sigma^2
        diag = torch.full((n,), 1.0, dtype=torch.float32, device=self.device) * s + sigma2
        return Operator(mv, (params["raw_lengthscale"], s, sigma2)), diag

    def pivchol_precond(self, params):
        """(operator, M): K + sigma^2 I as an ``Operator`` and its rank
        ``cfg.precond_rank`` pivoted-Cholesky preconditioner, the pair the
        BBMM loss and the iterative ``eval`` run on."""
        from ..ops.pivchol import make_pivchol_precond

        mv, d0 = self._covar_matvec_and_diag(params)
        return mv, make_pivchol_precond(mv, d0, self.cfg.precond_rank)

    @in_probe_role
    def mll_loss(self, params, generator: Optional[torch.Generator] = None,
                 probes=None):
        """Negative exact marginal log likelihood / n: dense Cholesky up to
        ``cfg.max_cholesky``; above it BBMM, with ``probes`` the pair
        (zm, zr) of ``ops.slq.slq_logdet_mbcg`` or probes drawn from
        ``generator``."""
        n = self.num_data
        resid = self.train_y - params["mean_constant"]
        if n <= self.cfg.max_cholesky:
            chol = torch.linalg.cholesky(self._train_covar(params))
            alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
            quad = torch.dot(resid, alpha)
            ld = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        else:
            from ..ops.cg import cg_solve
            from ..ops.slq import slq_logdet_mbcg

            cfg = self.cfg
            mv, pobj = self.pivchol_precond(params)
            alpha = cg_solve(mv, resid[:, None], tol=cfg.cg_tolerance,
                             max_iter=cfg.cg_max_iter, precond=pobj.apply)[:, 0]
            quad = torch.dot(resid, alpha)
            ld = slq_logdet_mbcg(mv, pobj, generator, cfg.num_probes, cfg.lanczos_max_iter,
                                 cg_tol=cfg.cg_tolerance, cg_max_iter=cfg.cg_max_iter,
                                 probes=probes)
        return 0.5 * (quad + ld + n * math.log(2.0 * math.pi)) / n

    @in_probe_role
    @torch.no_grad()
    def eval(self, params, love_rank: int = 100,
             generator: Optional[torch.Generator] = None,
             love_v0: Optional[torch.Tensor] = None):
        """Precompute the posterior cache: dense Cholesky up to
        ``cfg.max_cholesky``; above it the mean cache
        (K + sigma^2 I)^{-1} (y - mu) from pivoted-Cholesky-preconditioned
        CG and a rank-``love_rank`` LOVE root of the train covariance
        (``love_rank >= n`` exhausts the Krylov space: exact variances). The
        Lanczos start vector is ``love_v0`` ([n]) or drawn from
        ``generator`` (default: seed 0 on the model's device)."""
        n = self.num_data
        resid = self.train_y - params["mean_constant"]
        if n <= self.cfg.max_cholesky:
            chol = torch.linalg.cholesky(self._train_covar(params))
            alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
            self._cache = dict(chol=chol, alpha=alpha)
            return self
        from ..ops.cg import cg_raw
        from ..ops.eigen import lanczos_eigh

        mv, pobj = self.pivchol_precond(params)
        alpha = cg_raw(mv, resid[:, None], self.cfg.cg_tolerance, self.cfg.cg_max_iter,
                       precond=pobj.apply)[:, 0]
        rank = int(min(love_rank, n))
        if love_v0 is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            love_v0 = torch.randn((n,), generator=generator, dtype=torch.float32,
                                  device=generator.device)
        lam, vecs = lanczos_eigh(mv, love_v0.to(self.device), rank, rank)
        # Post-breakdown Ritz pairs come back as +inf values with NaN
        # vectors: zero-weight them.
        finite = torch.isfinite(lam)
        inv_lam = torch.where(finite, 1.0 / torch.where(finite, lam, 1.0), 0.0)
        vecs = torch.where(finite[None, :], torch.nan_to_num(vecs), 0.0)
        self._cache = dict(alpha=alpha, love=(inv_lam, vecs))
        return self

    @in_probe_role
    @torch.no_grad()
    def posterior(self, params, x, noisy_posterior: bool = False) -> Posterior:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        cache = self._cache
        s = self.outputscale(params).reshape(())
        k_star = s * self.kernel.gram(params, self.train_x, x)  # [n_train, n*]
        mean = params["mean_constant"] + (k_star.T @ cache["alpha"][:, None])[:, 0]
        k_ss = s * self.kernel.gram(params, x)
        if "love" in cache:
            # LOVE covariance: K** - K*t (V diag(1/lam) V') Kt*
            inv_lam, vecs = cache["love"]
            wv = k_star.T @ vecs
            covar = k_ss - (wv * inv_lam[None, :]) @ wv.T
        else:
            v = torch.linalg.solve_triangular(cache["chol"], k_star, upper=False)
            covar = k_ss - v.T @ v
        if noisy_posterior:
            covar = covar + self.noise(params).reshape(()) * torch.eye(
                covar.shape[0], dtype=covar.dtype, device=covar.device)
        stddev = torch.sqrt(torch.clamp(torch.diagonal(covar), min=0.0))
        return Posterior(mean=mean, covar=covar, stddev=stddev)
