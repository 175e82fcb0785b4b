"""Implicit-manifold GP regression model (port of
``manifold_gp_tpu.models.riemann_gp``).

Training: ``precision_matvec`` composes Schur (semisupervised) -> Scale ->
Noise over the kernel's Matérn precision (including the ``inverse_scale``
asymmetry documented in ``ops.matern``), ``mll_loss`` is the precision-form
negative log marginal likelihood. Every method is a function of a flat
params dict of tensors; gradients come from autograd with the solver
backwards of ``ops.cg`` / ``ops.slq``. Randomness (SLQ probes, one-hot
indices) is passed in or drawn from an explicit ``torch.Generator``.

Semisupervised (``labeled``, a boolean mask over the kernel's nodes): the
graph covers every node, the labels only the masked ones. The loss runs on
the labeled block's Schur complement of the precision, one inner CG on the
unlabeled block per apply, and the posterior reaches the labeled points
through Nyström features. The Schur complement runs on full-length masked
vectors in the model's vector space (``ops.matern.make_schur_matvec_masked``),
indexed only where the stack meets the compact labeled vectors.

Prediction uses the exact feature-space (Woodbury) posterior: with
K = s Z Z' + sigma^2 I and C = (sigma^2/s) I_m + Z'Z,
    mean_* = mu + Z_* C^{-1} Z'(y - mu)
    cov_** = sigma^2 Z_* C^{-1} Z_*'  (+ sigma^2 I when noisy)
— only m x m dense work (m = num_modes).

LOVE (``eval(love_rank=...)``) swaps the exact covariance for a rank-r
Lanczos root-inverse of the train covariance; ``posterior_samples`` draws
pathwise joint samples in feature space. ``posterior(base_model=...)``
blends in a vanilla GP away from the manifold (base_scale = 1 - bump of
the distance to the nearest graph node): means add, covariances add
outer(base_scale)-weighted, stddevs add scaled.

On a mesh kernel (``kernel.mesh``, one process per GPU) the training loss
runs in the kernel's padded row-sharded space, this rank's rows of it: the
labels, the labeled/unlabeled masks and the probes are embedded at their
support rows, the Schur complement is the masked form
(``make_schur_matvec_masked``), the preconditioners are the masked
``ops.pivchol`` classes, the SLQ trace dimension is the true label count,
and the exact log-det densifies the support block in 128-column chunks.
The loss is replicated: every rank returns the same value and, through
``parallel.mesh``'s autograd pair, the same complete gradients. Serving
(``eval``, ``posterior``) runs on the gathered basis, replicated, as on one
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, InferenceConfig
from ..ops import engine
from ..ops.bump import bump_function
from ..ops.matern import (
    _at_rows,
    make_jacobi_precond,
    make_noisy_matvec,
    make_scaled_matvec,
    make_schur_matvec_masked,
    noisy_scaled_diag,
)
from ..ops.operator import Operator
from ..ops.sparse_formats import permute_in, permute_out
from ..parallel.mesh import (
    enter_params,
    in_probe_role,
    leave_sharded,
    probe_split,
    row_sum,
    use_mesh,
)
from ..parameters import ConstrainedParam, GreaterThan, Positive
from ..utils.metrics import count, span, spanned


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
        self.device = kernel.device
        self.train_x = torch.as_tensor(train_x, dtype=torch.float32).to(self.device)
        self.train_y = torch.as_tensor(train_y, dtype=torch.float32).to(self.device)
        self.kernel = kernel
        self.cfg = cfg
        self.use_outputscale = use_outputscale
        self.labeled = None if labeled is None else np.asarray(labeled, bool)
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
        # The model's vector space, decided once: this rank's rows of the
        # padded row-sharded space on a mesh kernel, padded-RCM order on a
        # sparse layout, node order otherwise. ``_mask_l`` / ``_mask_u``: the
        # 0/1 labeled and unlabeled row masks there (padding, halo and pad
        # rows in neither); on a mesh ``_mask_l`` marks the support (every
        # node of a supervised model), and the labels sit at their support
        # rows. A labeled single-device model keeps its labeled rows'
        # positions there (``_space_rows``, the Schur boundary).
        self.mesh = getattr(kernel, "mesh", None)
        if self.mesh is not None:
            n_nodes = kernel.graph.num_nodes
            lo, count = kernel.mesh_row_range
            support = (np.flatnonzero(self.labeled) if self.labeled is not None
                       else np.arange(n_nodes))
            rows = kernel.mesh_rows_np[support] - lo
            mine = np.flatnonzero((rows >= 0) & (rows < count))

            def dev(a, dtype=torch.int64):
                return torch.as_tensor(a).to(device=self.device, dtype=dtype)

            self._support_local_rows = dev(rows[mine])
            self._support_local_ids = dev(mine)
            y_pad = np.zeros(count, np.float32)
            y_pad[rows[mine]] = self.train_y.cpu().numpy()[mine]
            mask_l = np.zeros(count, np.float32)
            mask_l[rows[mine]] = 1.0
            mask_u = np.zeros(count, np.float32)
            if self.labeled is not None:
                urows = kernel.mesh_rows_np[np.flatnonzero(~self.labeled)] - lo
                mask_u[urows[(urows >= 0) & (urows < count)]] = 1.0
            self._y_pad = dev(y_pad, torch.float32)
            self._mask_l = dev(mask_l, torch.float32)
            self._mask_u = dev(mask_u, torch.float32)
        elif self.labeled is not None:
            self._labeled_rows = torch.as_tensor(np.flatnonzero(self.labeled),
                                                 device=self.device)
            mask_l = torch.as_tensor(self.labeled, dtype=torch.float32, device=self.device)
            self._mask_l, self._mask_u = mask_l, 1.0 - mask_l
            self._space_rows = self._labeled_rows
            layout = kernel.block_layout
            if layout is not None:
                self._mask_l = permute_in(layout, self._mask_l)
                self._mask_u = permute_in(layout, self._mask_u)
                self._space_rows = layout.unperm[self._labeled_rows]

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
        count("host_sync.params.init")  # a host scalar copied to the device
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

    @property
    def num_data(self) -> int:
        return int(self.train_y.shape[0])

    # -- precision operator stack -----------------------------------------
    def precision_matvec(self, params, noise: bool = True, coeffs=None) -> Operator:
        """Compose Schur (semisupervised) -> Scale -> Noise over the
        kernel's precision, in the model's vector space (``__init__``):
        padded-RCM order on a sparse layout (block-ELL or DIA), node order
        without one, this rank's rows of the padded space on a mesh kernel.

        A labeled model runs the masked Schur complement
        (``make_schur_matvec_masked`` over the model's masks, Jacobi on the
        kernel's diagonal carried into the same space), so its inner
        solves gather and permute nothing. On one device a boundary wraps
        the whole stack: the scalar Scale/Noise wrappers commute with the
        permutation, and S maps vectors supported on the labeled rows to
        such vectors, so one boundary replaces per-Laplacian-matvec row
        gathers (a noisy nu=2 apply does 6 of them). Supervised on a
        layout, it is one permute_in/out pair; labeled, it embeds the
        compact labeled vector at the labeled rows' positions and selects
        them back (``ops.matern._at_rows``, counters
        ``schur.gathers.embed`` / ``.select``). On a mesh there is no
        boundary: callers embed at the support rows (``support_rows``)."""
        mv = self.kernel.precision_matvec(params, coeffs=coeffs, permuted_io=True)
        if self.labeled is not None:
            pd = (self._precision_diag_in_space(params, coeffs=coeffs)
                  if self.cfg.cg_precondition else None)
            mv = make_schur_matvec_masked(mv, self._mask_l, self._mask_u,
                                          cg_tol=self.cfg.cg_tolerance,
                                          cg_max_iter=self.cfg.cg_max_iter, precond_diag=pd)
        if self.use_outputscale:
            mv = make_scaled_matvec(mv, self.outputscale(params))
        if noise:
            mv = make_noisy_matvec(mv, self.noise(params))
        if self.mesh is not None:
            return mv
        if self.labeled is not None:
            return _at_rows(mv, self._space_rows, self._mask_l.shape[0])
        layout = self.kernel.block_layout
        if layout is None:
            return mv
        inner = mv.fn

        def fn(v, *consts):
            squeeze = v.dim() == 1
            out = permute_out(layout, inner(permute_in(layout, v[:, None] if squeeze else v),
                                            *consts))
            return out[:, 0] if squeeze else out

        return Operator(fn, mv.consts)

    # -- the row-sharded path (mesh kernels) -----------------------------------
    def support_rows(self, values: torch.Tensor) -> torch.Tensor:
        """[n, ...] values over the training points (node order of the
        support) -> this rank's rows of their padded embedding, zero
        elsewhere; the values themselves on one device."""
        if self.mesh is None:
            return values
        out = values.new_zeros((self._y_pad.shape[0],) + tuple(values.shape[1:]))
        out[self._support_local_rows] = values[self._support_local_ids]
        return out

    @torch.no_grad()
    def _precision_diag_in_space(self, params, coeffs=None):
        """diag(Q) in the model's vector space: on a mesh, this rank's rows
        of the padded space (1.0 on padding, so a Jacobi division is the
        identity there); padded-RCM order on a layout; node order
        otherwise."""
        d = self.kernel.precision_diag(params, coeffs=coeffs)
        if self.mesh is not None:
            return self.kernel.embed_mesh_coeff(d, fill=1.0)
        layout = self.kernel.block_layout
        return d if layout is None else permute_in(layout, d)

    @torch.no_grad()
    def _precond_obj_sharded(self, params, matvec=None, coeffs=None):
        """The masked preconditioner of the padded composed operator per
        cfg.precond_type: ``MaskedDiagPrecond`` on the noisy-scaled padded
        diagonal ("jacobi"), or a rank-``precond_rank`` masked pivoted
        Cholesky of ``matvec`` ("pivchol"). None when preconditioning is
        off. Call it under the model's mesh context."""
        cfg = self.cfg
        if not cfg.cg_precondition or cfg.precond_type == "none":
            return None
        from ..ops.pivchol import MaskedDiagPrecond, make_pivchol_precond_masked

        mask = self._mask_l
        d_noisy = noisy_scaled_diag(
            self._precision_diag_in_space(params, coeffs=coeffs),
            scale=self.outputscale(params) if self.use_outputscale else None,
            noise=self.noise(params),
        )
        d_noisy = torch.where(mask > 0, d_noisy, torch.ones_like(d_noisy))
        if cfg.precond_type == "pivchol" and matvec is not None:
            return make_pivchol_precond_masked(matvec, d_noisy, mask, cfg.precond_rank)
        return MaskedDiagPrecond(d=d_noisy, mask=mask)

    def _dense_support_logdet(self, mv):
        """log det of the support block of the padded operator: its columns
        densified 128 at a time (one-hot columns at this rank's support
        rows), each rank's support rows summed into the replicated [n, n]
        block (the ranks' rows are disjoint: the sum gathers them), then a
        Cholesky."""
        from ..parallel.mesh import leave_sharded

        n = self.num_data
        count = self._y_pad.shape[0]
        rows, ids = self._support_local_rows, self._support_local_ids
        chunk = 128
        cols = []
        for c0 in range(0, n, chunk):
            w = min(chunk, n - c0)
            sel = (ids >= c0) & (ids < c0 + w)
            rhs = torch.zeros((count, w), dtype=torch.float32, device=self.device)
            rhs[rows[sel], ids[sel] - c0] = 1.0
            out = mv(rhs)
            part = out.new_zeros((n, w)).index_copy(0, ids, out[rows])
            cols.append(leave_sharded(part, self.mesh))
        dense = torch.cat(cols, dim=1)
        chol = torch.linalg.cholesky(dense)
        return 2.0 * torch.sum(torch.log(torch.diagonal(chol)))

    def _mll_loss_sharded(self, params, generator=None, precond_override=None, probes=None):
        """``mll_loss`` on the row-sharded mesh path: the same math (and the
        same probes, embedded at the support rows) on this rank's rows of
        the padded space. ``probes`` are node-order [n, P] (a pair for the
        mBCG log-det), as on one device."""
        n = self.num_data
        cfg = self.cfg
        with use_mesh(self.mesh):
            c = self.kernel.coeffs(params)
            mv = self.precision_matvec(params, noise=True, coeffs=c)
            y_pad = self._y_pad
            quad = row_sum(y_pad * mv(y_pad[:, None])[:, 0])
            if n <= cfg.max_cholesky:
                ld = self._dense_support_logdet(mv)
            else:
                pobj = (precond_override if precond_override is not None
                        else self._precond_obj_sharded(params, matvec=mv, coeffs=c))
                if cfg.slq_precond_quadrature and pobj is not None:
                    from ..ops.slq import slq_logdet_mbcg

                    pair = None if probes is None else tuple(self.support_rows(p)
                                                             for p in probes)
                    ld = slq_logdet_mbcg(mv, pobj, generator, cfg.num_probes,
                                         cfg.lanczos_max_iter, cg_tol=cfg.cg_tolerance,
                                         cg_max_iter=cfg.cg_max_iter, probes=pair)
                else:
                    from ..ops.slq import rademacher_probes, slq_logdet

                    if probes is None:
                        if generator is None:
                            raise ValueError("stochastic logdet needs probes or a "
                                             "torch.Generator")
                        probes = rademacher_probes(generator, n, cfg.num_probes,
                                                   device=self.device)
                    ld = slq_logdet(mv, self.support_rows(probes.to(self.device)),
                                    num_steps=cfg.lanczos_max_iter, cg_tol=cfg.cg_tolerance,
                                    cg_max_iter=cfg.cg_max_iter,
                                    precond=None if pobj is None else pobj.apply,
                                    num_nodes=n)
        loss = 0.5 * (quad - ld + n * math.log(2.0 * math.pi))
        for _, prior, value_fn in self.kernel.priors():
            loss = loss - torch.sum(prior.log_prob(value_fn(params)))
        return loss / n

    @in_probe_role
    def precision_precond_obj(self, params, noise: bool = True, coeffs=None, matvec=None):
        """Preconditioner OBJECT (``ops.pivchol`` protocol: apply / sample /
        logdet) for the composed precision operator, per cfg.precond_type:

          * "jacobi": diag(Q) pushed through the Scale/Noise wrappers (for
            the Schur complement: its labeled rows, an approximation);
          * "pivchol": rank-``cfg.precond_rank`` partial pivoted Cholesky of
            the composed operator itself (``matvec``; without it, Jacobi, as
            in the reference).

        None when cfg.cg_precondition is off or precond_type == "none".
        Detached: a preconditioner never changes solutions, so no gradient
        flows through it. On a mesh kernel: ``_precond_obj_sharded``."""
        cfg = self.cfg
        if self.mesh is not None:
            with use_mesh(self.mesh):
                return self._precond_obj_sharded(params, matvec=matvec, coeffs=coeffs)
        if not cfg.cg_precondition or cfg.precond_type == "none":
            return None
        from ..ops.pivchol import DiagPrecond, make_pivchol_precond

        with torch.no_grad():
            d = self.kernel.precision_diag(params, coeffs=coeffs)
            if self.labeled is not None:
                d = d.index_select(0, self._labeled_rows)
            d = noisy_scaled_diag(
                d,
                scale=self.outputscale(params) if self.use_outputscale else None,
                noise=self.noise(params) if noise else None,
            )
        if cfg.precond_type == "pivchol" and matvec is not None:
            return make_pivchol_precond(matvec, d, cfg.precond_rank)
        return DiagPrecond(d=d)

    def precision_precond(self, params, noise: bool = True, coeffs=None, matvec=None):
        """M^{-1} apply-closure view of ``precision_precond_obj`` (the CG
        hook). None when preconditioning is off."""
        obj = self.precision_precond_obj(params, noise=noise, coeffs=coeffs, matvec=matvec)
        return None if obj is None else obj.apply

    @in_probe_role
    @torch.no_grad()
    def build_precond(self, params):
        """Freshly built config-selected preconditioner OBJECT for the
        composed noisy precision — the cacheable unit for ``precond_refresh``
        training: pivchol costs ``precond_rank`` composed matvecs, and since
        the object is detached, rebuilding it every k epochs instead of every
        loss evaluation changes only iteration counts, never gradients."""
        c = self.kernel.coeffs(params)
        mv = self.precision_matvec(params, noise=True, coeffs=c)
        return self.precision_precond_obj(params, noise=True, coeffs=c, matvec=mv)

    @in_probe_role
    @torch.no_grad()
    def deflation_precond(self, params, basis=None):
        """Spectral-deflation preconditioner for the composed noisy-scaled
        precision operator, built from the kernel's spectral basis
        (``basis`` = (eigval, eigvec) as ``eval_basis`` returns it, at these
        hyperparameters; solved when None). Pass the result as
        ``precond_override`` to :meth:`mll_loss`.

        Symmetric normalization: the symmetric-Laplacian eigenvectors are
        eigenvectors of the whole composed stack (a polynomial in L), with
        eigenvalues noise(scale * (2 nu / l^2 + lambda)^nu): exact
        deflation. Randomwalk: Q_rw = D^{1/2} (shift I + L_sym)^nu D^{1/2},
        so the symmetric deflation extends by degree conjugation
        (``ConjugatedPrecond``), approximate for the noisy composition (the
        noise eigenvalue uses sigma^2 * mean(deg) as the effective scale).
        The bulk scale tau is the composed value at the geometric mean of
        the undeflated spectrum window [lambda_m, Gershgorin bound].

        Supervised only: the Schur complement's eigenvectors are not L's.
        """
        if self.labeled is not None:
            raise ValueError("deflation_precond needs the unmarginalized stack: "
                             "the model is semisupervised")
        from ..ops.laplacian import gershgorin_bound
        from ..ops.pivchol import ConjugatedPrecond, make_deflation_precond

        randomwalk = self.kernel.laplacian_normalization == "randomwalk"
        if basis is None:
            basis = self.kernel.eval_basis(params)
        eigval, eigvec = basis
        c = self.kernel.coeffs(params)
        # Undo eval_basis's D^{-1/2} recovery and renormalize: the
        # orthonormal symmetric eigenvectors again.
        v = eigvec * torch.sqrt(c.deg)[:, None]
        v = v / torch.linalg.norm(v, dim=0, keepdim=True)

        nu = self.kernel.nu
        ls2 = torch.square(self.kernel.lengthscale(params).reshape(()))
        s2 = self.noise(params).reshape(())
        if randomwalk:
            # noise terms see Q_rw ~ deg * Q_sym in scale
            s2 = s2 * torch.mean(c.deg)
        scale = self.outputscale(params).reshape(()) if self.use_outputscale else None

        def composed_eig(lam):
            q = torch.pow(2.0 * nu / ls2 + lam, float(nu))
            if scale is not None:
                q = q * scale
            return q * (1.0 - s2 * q * (1.0 - s2 * q))

        q = composed_eig(eigval)
        q = torch.maximum(q, 1e-12 * torch.max(q))
        lam_hi = gershgorin_bound(self.kernel.graph, c)
        lam_mid = torch.sqrt(torch.clamp(eigval[-1], min=1e-12) * lam_hi)
        tau = torch.maximum(composed_eig(lam_mid), 1e-12 * torch.max(q))
        if self.mesh is None:
            core = make_deflation_precond(v, q, tau)
            if randomwalk:
                return ConjugatedPrecond(d=torch.sqrt(c.deg), inner=core)
            return core
        # on a mesh: the eigenvectors at this rank's rows of the padded space
        core = make_deflation_precond(self.kernel.embed_mesh_rows(v), q, tau,
                                      mask=self._mask_l)
        if randomwalk:
            return ConjugatedPrecond(d=self.kernel.embed_mesh_coeff(torch.sqrt(c.deg), fill=1.0),
                                     inner=core)
        return core

    # -- training loss -----------------------------------------------------
    @in_probe_role
    @spanned("imgp.model.mll_loss")
    def mll_loss(self, params, generator: Optional[torch.Generator] = None,
                 precond_override=None, probes: Optional[torch.Tensor] = None):
        """Precision-form negative log marginal likelihood:
            0.5 [ y' Q y - logdet Q + n log 2pi ] - sum log p(priors), all / n.
        Exact (dense Cholesky) when n <= cfg.max_cholesky, else SLQ with
        ``probes`` ([n, cfg.num_probes] Rademacher) or probes drawn from
        ``generator``, with preconditioned gradient solves when
        cfg.cg_precondition, and the preconditioned (mBCG) quadrature when
        cfg.slq_precond_quadrature (then ``probes`` is the pair (zm, zr) of
        ``ops.slq.slq_logdet_mbcg``).

        ``precond_override``: a preconditioner object (``ops.pivchol``) to use
        in place of the config-selected one, e.g. one cached across epochs
        (``build_precond``) or ``deflation_precond``'s.

        Under a user's ``use_mesh`` the plain SLQ path splits its probe
        columns over the ranks (``parallel.mesh``, the probe role): every
        rank returns the whole loss and, after the backward, the whole
        gradients.
        """
        if self.mesh is not None:
            return self._mll_loss_sharded(params, generator=generator,
                                          precond_override=precond_override, probes=probes)
        n = self.num_data
        y = self.train_y
        cfg = self.cfg
        # the mBCG quadrature keeps its probes whole (JAX places only the
        # plain SLQ's); the dense path has none
        mbcg = cfg.slq_precond_quadrature and (
            precond_override is not None
            or (cfg.cg_precondition and cfg.precond_type != "none"))
        split = None
        if n > cfg.max_cholesky and not mbcg:
            split = probe_split(cfg.num_probes if probes is None else probes.shape[1])
        if split is not None:
            params = enter_params(params, split)
        # One coefficient computation shared by the operator and the
        # preconditioner.
        c = self.kernel.coeffs(params)
        mv = self.precision_matvec(params, noise=True, coeffs=c)
        quad = torch.dot(y, mv(y[:, None])[:, 0])
        pobj = (
            precond_override
            if precond_override is not None
            else self.precision_precond_obj(params, noise=True, coeffs=c, matvec=mv)
        )
        if mbcg and n > cfg.max_cholesky:
            # mBCG: probes from M, PCG-coefficient quadrature on
            # M^{-1/2} Q M^{-1/2}, plus logdet(M) (ops/slq.py).
            from ..ops.slq import slq_logdet_mbcg

            ld = slq_logdet_mbcg(
                mv, pobj, generator, cfg.num_probes, cfg.lanczos_max_iter,
                cg_tol=cfg.cg_tolerance, cg_max_iter=cfg.cg_max_iter, probes=probes,
            )
        else:
            ld = engine.logdet(
                mv, n, cfg, generator=generator, probes=probes, device=self.device,
                precond=None if pobj is None else pobj.apply,
            )
        loss = 0.5 * (quad - ld + n * math.log(2.0 * math.pi))
        for _, prior, value_fn in self.kernel.priors():
            loss = loss - torch.sum(prior.log_prob(value_fn(params)))
        if split is not None:
            # this rank's share: its probes' log-det, the replicated terms
            # divided by the world size; the ranks' shares sum to the loss
            return leave_sharded(loss / (n * split.world_size), split)
        return loss / n

    @in_probe_role
    def average_variance(self, params, num_rand_vec: int = 100,
                         generator: Optional[torch.Generator] = None, idx=None):
        """Mean diagonal of the *unscaled* kernel-precision inverse (the
        full precision over every graph node, labeled or not), over all
        nodes when num_rand_vec >= N, else over ``num_rand_vec`` nodes
        (``idx``, or drawn from ``generator``)."""
        nn = self.kernel.graph.num_nodes
        split = probe_split(num_rand_vec) if num_rand_vec < nn else None
        if split is not None:  # a user's use_mesh: the one-hot columns split over the ranks
            params = enter_params(params, split)
        mv = self.kernel.precision_matvec(params)
        if self.mesh is not None:
            return self._average_variance_sharded(mv, params, nn, num_rand_vec, generator, idx)
        precond = (
            make_jacobi_precond(self.kernel.precision_diag(params))
            if self.cfg.cg_precondition
            else None
        )
        out = engine.average_variance(
            mv, nn, num_rand_vec, self.cfg, generator=generator, precond=precond,
            idx=idx, device=self.device,
        )
        return out if split is None else leave_sharded(out, split)

    def _average_variance_sharded(self, mv, params, nn, num_rand_vec, generator, idx):
        """``average_variance`` on the mesh: one-hot columns at the padded
        rows of the chosen nodes (drawn at the global shape), one sharded
        Jacobi-preconditioned CG solve, the mean of their diagonal."""
        from ..ops.cg import cg_solve

        cfg = self.cfg
        if num_rand_vec >= nn:
            idx = torch.arange(nn, device=self.device)
        elif idx is None:
            if generator is None:
                raise ValueError("average_variance needs idx or a torch.Generator")
            idx = torch.randint(0, nn, (num_rand_vec,), generator=generator,
                                device=generator.device)
        idx = torch.as_tensor(idx).to(device=self.device, dtype=torch.int64)
        lo, count = self.kernel.mesh_row_range
        rows = self.kernel.mesh_rows[idx] - lo
        mine = (rows >= 0) & (rows < count)
        rhs = torch.zeros((count, idx.shape[0]), dtype=torch.float32, device=self.device)
        rhs[rows[mine], torch.arange(idx.shape[0], device=self.device)[mine]] = 1.0
        precond = (make_jacobi_precond(self._precision_diag_in_space(params))
                   if cfg.cg_precondition else None)
        with use_mesh(self.mesh):
            x = cg_solve(mv, rhs, tol=cfg.cg_tolerance, max_iter=cfg.cg_max_iter,
                         precond=precond, log_label="avg_var")
            return row_sum(torch.sum(rhs * x, dim=1)) / idx.shape[0]

    # -- prediction --------------------------------------------------------
    @in_probe_role
    @spanned("imgp.model.eval")
    @torch.no_grad()
    def eval(self, params, love_rank: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             love_v0: Optional[torch.Tensor] = None):
        """Precompute the spectral basis + feature-space posterior cache.

        ``love_rank``: opt-in LOVE predictive variances (GPyTorch's
        ``fast_pred_var``): a rank-r Lanczos root-inverse of the train
        covariance K = s Z Z' + sigma^2 I replaces the exact Woodbury cache
        in the predictive covariance; the mean stays exact. With
        ``love_rank >= n_train`` the Krylov space is exhausted and LOVE
        reproduces the exact variances. The Lanczos start vector is
        ``love_v0`` ([n_train]) or drawn from ``generator`` (default: seed 0
        on the model's device).
        """
        with span("imgp.model.eval_basis"):
            basis = self.kernel.eval_basis(params)
        with span("imgp.model.features"):
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
        count("host_sync.cholesky.eval")  # cholesky checks its info on the host
        chol_c = torch.linalg.cholesky(c)
        resid = self.train_y - mu
        u = z.T @ resid[:, None]
        w = torch.cholesky_solve(u, chol_c)[:, 0]
        self._cache = dict(basis=basis, chol_c=chol_c, w=w, s=s, sigma2=sigma2, mu=mu)
        if love_rank is not None:
            from ..ops.eigen import lanczos_eigh

            n_tr = z.shape[0]
            rank = int(min(love_rank, n_tr))

            def khat_mv(v):
                vv = v[:, None] if v.dim() == 1 else v
                out = s * (z @ (z.T @ vv)) + sigma2 * vv
                return out[:, 0] if v.dim() == 1 else out

            if love_v0 is None:
                if generator is None:
                    generator = torch.Generator(device=self.device).manual_seed(0)
                love_v0 = torch.randn((n_tr,), generator=generator, dtype=torch.float32,
                                      device=generator.device)
            lam, vecs = lanczos_eigh(khat_mv, love_v0.to(self.device), rank, rank)
            # After the Krylov space is exhausted the spurious Ritz pairs come
            # back as +inf values with NaN vectors: zero-weight them.
            finite = torch.isfinite(lam)
            inv_lam = torch.where(finite, 1.0 / torch.where(finite, lam, 1.0), 0.0)
            vecs = torch.where(finite[None, :], torch.nan_to_num(vecs), 0.0)
            self._cache["love"] = (inv_lam, vecs, z)
        return self

    @torch.no_grad()
    def modulation(self, params, x):
        """bump(distance to nearest training graph point)."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        d, _ = self.kernel.knn.search(x, 1, self_query=False)
        gb = self.kernel.graphbandwidth(params).reshape(())
        return bump_function(
            torch.sqrt(d[:, 0].to(self.device)), self.kernel.bump_scale * gb,
            self.kernel.bump_decay
        )

    @in_probe_role
    @spanned("imgp.model.posterior")
    @torch.no_grad()
    def posterior(self, params, x, noisy_posterior: bool = False, base_model=None,
                  base_params=None, is_train: Optional[bool] = None) -> Posterior:
        """Geometric posterior at ``x``, blended with ``base_model`` (a
        vanilla GP, evaluated at ``base_params``) away from the manifold
        when given; ``is_train=True`` forces the in-sample feature path."""
        cache = self._cache
        with span("imgp.model.features"):
            zs = self.kernel.features(params, cache["basis"], x, is_train=is_train)
        mean = cache["mu"] + (zs @ cache["w"][:, None])[:, 0]
        if "love" in cache:
            # LOVE covariance: K** - K*t (V diag(1/lam) V') Kt* with the rank-r
            # Lanczos Ritz pairs of the train covariance (eval()).
            inv_lam, vecs, z_tr = cache["love"]
            s = cache["s"]
            wv = (s * (zs @ z_tr.T)) @ vecs
            covar = s * (zs @ zs.T) - (wv * inv_lam[None, :]) @ wv.T
        else:
            half = torch.linalg.solve_triangular(cache["chol_c"], zs.T, upper=False)
            covar = cache["sigma2"] * (half.T @ half)
        if noisy_posterior:
            covar = covar + cache["sigma2"] * torch.eye(
                covar.shape[0], dtype=covar.dtype, device=covar.device
            )
        stddev = torch.sqrt(torch.clamp(torch.diagonal(covar), min=0.0))
        if base_model is not None:
            base_post = base_model.posterior(base_params, x, noisy_posterior)
            base_scale = 1.0 - self.modulation(params, x)
            mean = mean + base_scale * base_post.mean
            covar = covar + torch.outer(base_scale, base_scale) * base_post.covar
            stddev = stddev + base_scale * base_post.stddev
        return Posterior(mean=mean, covar=covar, stddev=stddev)

    @in_probe_role
    @torch.no_grad()
    def posterior_samples(self, params, x, generator: Optional[torch.Generator],
                          num_samples: int, noisy_posterior: bool = False,
                          is_train: Optional[bool] = None, xi: Optional[torch.Tensor] = None,
                          eta: Optional[torch.Tensor] = None):
        """Pathwise joint posterior samples at ``x``: [num_samples, n*].

        Feature-space sampling in O(m^2 + n* m) per draw, with C = L L' from
        eval()'s cache (cov = sigma^2 Z* C^{-1} Z*'):

            f = mean + sigma * Z* L^{-T} xi,   xi ~ N(0, I_m)
            (+ sigma * eta per point when noisy_posterior)

        ``xi`` ([m, num_samples]) and ``eta`` ([num_samples, n*]) are drawn
        from ``generator`` unless passed in.
        """
        cache = self._cache
        with span("imgp.model.features"):
            zs = self.kernel.features(params, cache["basis"], x, is_train=is_train)
        mean = cache["mu"] + (zs @ cache["w"][:, None])[:, 0]
        m = cache["chol_c"].shape[0]
        if xi is None:
            xi = torch.randn((m, num_samples), generator=generator, dtype=torch.float32,
                             device=generator.device)
        # cov(L^{-T} xi) = C^{-1}
        half = torch.linalg.solve_triangular(cache["chol_c"].T, xi.to(zs.device),
                                             upper=True)
        sigma = torch.sqrt(cache["sigma2"])
        f = mean[None, :] + sigma * (zs @ half).T
        if noisy_posterior:
            if eta is None:
                eta = torch.randn(tuple(f.shape), generator=generator, dtype=torch.float32,
                                  device=generator.device)
            f = f + sigma * eta.to(f.device)
        return f
