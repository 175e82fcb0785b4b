"""Riemann (graph-spectral) kernels (port of ``manifold_gp_tpu.kernels.riemann``,
single device).

The kernel holds the data, the kNN graph, the block-ELL layout and the
normalization flags; learnable state is the flat params dict
({'raw_graphbandwidth', 'raw_lengthscale'}). ``eval_basis`` solves the
spectral basis: dense ``torch.linalg.eigh`` at or below ``eigh_max_size``,
above it block LOBPCG (the default ``eigensolver="lobpcg"``) or
Chebyshev-filtered subspace iteration, every Laplacian apply of which goes
through the fused SpMV of the kernel's layout (a CUDA kernel on a card), or,
with ``eigensolver="host_f64"``, the float64 shift-invert solver on the host
at any size. Then the reference's post-processing: eigval[0] =
0, D^{-1/2} recovery, column L2 normalization. ``precision_matvec`` /
``precision_diag`` are the Matérn precision operator that training solves
with and its Jacobi diagonal. ``block_layout`` holds either layout of
``ops.sparse_formats`` (block-ELL panels or DIA bands).

Not ported yet: the mesh path (its masked LOBPCG among it).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, InferenceConfig, resolve_device
from ..ops.bump import bump_function
from ..ops.eigen import chebyshev_filtered_smallest, host_f64_smallest, lobpcg_smallest
from ..ops.graph import build_graph
from ..ops.knn import NearestNeighbors
from ..ops.laplacian import (
    gershgorin_bound,
    laplacian_coeffs,
    laplacian_dense,
    laplacian_matvec,
    out_of_sample,
)
from ..parameters import ConstrainedParam, Positive


def _matrix_free_smallest(cfg, matvec, n_rows, m, bound, device):
    """cfg-dispatched large-N basis solver: block LOBPCG (the default) or
    Chebyshev-filtered subspace iteration. Both draw their start block from
    an explicit generator with seed 0; the Chebyshev path oversamples the
    block by ~25% and slices back."""
    generator = torch.Generator(device=device).manual_seed(0)
    if cfg.eigensolver != "chebyshev":
        x0 = torch.randn((n_rows, m), generator=generator, dtype=torch.float32,
                         device=device)
        return lobpcg_smallest(matvec, x0, bound, max_iter=cfg.eigensolver_max_iter)
    mb = min(m + max(8, m // 4), n_rows)
    x0 = torch.randn((n_rows, mb), generator=generator, dtype=torch.float32,
                     device=device)
    return chebyshev_filtered_smallest(
        matvec, x0, bound, num_modes=m, degree=cfg.cheb_degree,
        num_iters=cfg.cheb_iters,
    )


def _panel_dtype_of(cfg):
    """cfg.spmv_dtype -> assemble() dtype."""
    return {"bfloat16": torch.bfloat16, "float32x3": "float32x3"}.get(cfg.spmv_dtype)


class RiemannKernel:
    """Abstract graph-spectral kernel over an implicit manifold."""

    def __init__(
        self,
        x,
        nearest_neighbors: int = 10,
        laplacian_normalization: str = "symmetric",
        num_modes: int = 100,
        bump_scale: float = 1.0,
        bump_decay: float = 0.01,
        graphbandwidth_prior=None,
        graphbandwidth_constraint=None,
        cfg: InferenceConfig = DEFAULT_CONFIG,
        graph=None,
        knn_index=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if cfg.spmv_kernel == "cuda" and self.device.type != "cuda":
            raise ValueError("spmv_kernel='cuda' needs device='cuda'")
        self.x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if knn_index is not None:
            # a same-shape index over other points would gather out-of-sample
            # features into the wrong eigvec rows
            if knn_index.x.shape != self.x.shape or not torch.equal(
                knn_index.x.cpu(), self.x.cpu()
            ):
                raise ValueError("knn_index must be built over the kernel's own points")
            self.knn = knn_index
        else:
            self.knn = NearestNeighbors(self.x)
        self.nearest_neighbors = int(nearest_neighbors)
        # ``graph``: inject a prebuilt SparseGraph instead of the exact build.
        self.graph = (
            graph if graph is not None
            else build_graph(self.x, self.nearest_neighbors, device=self.device)
        )
        self.laplacian_normalization = laplacian_normalization
        self.num_modes = int(num_modes)
        self.bump_scale = float(bump_scale)
        self.bump_decay = float(bump_decay)
        self.graphbandwidth_prior = graphbandwidth_prior
        self.cfg = cfg
        self._param_decls = [
            ConstrainedParam(
                "graphbandwidth",
                graphbandwidth_constraint
                if graphbandwidth_constraint is not None
                else Positive(),
            ),
            ConstrainedParam("lengthscale", Positive()),
        ]
        self.use_dense_operator = self.graph.num_nodes <= cfg.dense_operator_max_size
        self.block_layout = None
        if not self.use_dense_operator and cfg.use_block_sparse:
            from ..ops.sparse_formats import build_layout

            self.block_layout = build_layout(
                self.graph, dia_max_offsets=cfg.dia_max_offsets, use_dia=cfg.use_dia
            )

    # -- parameters --------------------------------------------------------
    def init_params(self, graphbandwidth=None, lengthscale=None) -> dict:
        vals = {"graphbandwidth": graphbandwidth, "lengthscale": lengthscale}
        return {
            d.raw_name: d.init_raw(vals.get(d.name), device=self.device)
            for d in self._param_decls
        }

    def _decl(self, name) -> ConstrainedParam:
        return next(d for d in self._param_decls if d.name == name)

    def graphbandwidth(self, params):
        return self._decl("graphbandwidth").value(params)

    def lengthscale(self, params):
        return self._decl("lengthscale").value(params)

    def priors(self):
        """(name, prior, value_fn) triples for the training loss."""
        out = []
        if self.graphbandwidth_prior is not None:
            out.append(
                ("graphbandwidth_prior", self.graphbandwidth_prior, self.graphbandwidth)
            )
        return out

    # -- Laplacian ---------------------------------------------------------
    def coeffs(self, params, self_loops: bool = True):
        return laplacian_coeffs(self.graph, self.graphbandwidth(params), self_loops)

    def _operator_state(self, c):
        """(dense, block) execution-path state for the current coefficients."""
        if self.use_dense_operator:
            return laplacian_dense(self.graph, c), None
        if self.block_layout is not None:
            from ..ops.sparse_formats import assemble

            blocks = assemble(self.block_layout, c.diag, c.triu,
                              dtype=_panel_dtype_of(self.cfg))
            return None, (self.block_layout, blocks)
        return None, None

    def laplacian_matvec(self, params, v, transposed: bool = False):
        c = self.coeffs(params)
        dense, block = self._operator_state(c)
        return laplacian_matvec(
            self.graph, c, v, self.laplacian_normalization, transposed,
            dense=dense, block=block,
        )

    # -- spectral basis ----------------------------------------------------
    @torch.no_grad()
    def eval_basis(self, params):
        """(eigval [m], eigvec [N, m]) of the graph Laplacian, with the
        reference's truncation and randomwalk-recovery post-processing."""
        if self.cfg.eigensolver == "host_f64":
            return self._eval_basis_host_f64(params)
        c = self.coeffs(params)
        n = self.graph.num_nodes
        m = min(self.num_modes, n)
        if n <= self.cfg.eigh_max_size:
            eigval, eigvec = torch.linalg.eigh(laplacian_dense(self.graph, c))
            eigval, eigvec = eigval[:m], eigvec[:, :m]
        else:
            # Always f32 panels here: the low band needs full matvec
            # precision, and the basis solve runs once per eval.
            block = None
            if self.block_layout is not None:
                from ..ops.sparse_formats import assemble

                block = (self.block_layout, assemble(self.block_layout, c.diag, c.triu))
            eigval, eigvec = _matrix_free_smallest(
                self.cfg,
                lambda v: laplacian_matvec(self.graph, c, v, "symmetric", block=block),
                n, m, gershgorin_bound(self.graph, c), self.device,
            )
        eigval = eigval.clone()
        eigval[0] = 0.0
        eigvec = eigvec * torch.rsqrt(c.deg)[:, None]
        eigvec = eigvec / torch.linalg.norm(eigvec, dim=0, keepdim=True)
        return eigval, eigvec

    def _eval_basis_host_f64(self, params):
        """The f64 shift-invert basis on the host (``host_f64_smallest``),
        post-processed in f64 before one f32 cast onto the kernel's device."""
        import numpy as np

        gb = float(self.graphbandwidth(params))
        m = min(self.num_modes, self.graph.num_nodes)
        eigval, eigvec, deg = host_f64_smallest(self.graph, gb, m)
        eigval = np.asarray(eigval).copy()
        eigval[0] = 0.0
        eigvec = np.asarray(eigvec) / np.sqrt(deg)[:, None]
        eigvec = eigvec / np.linalg.norm(eigvec, axis=0, keepdims=True)
        return (torch.as_tensor(eigval, dtype=torch.float32).to(self.device),
                torch.as_tensor(eigvec, dtype=torch.float32).to(self.device))

    # -- spectral features -------------------------------------------------
    def _normalized_density(self, params, eigval, nystrom_correction: bool):
        density = self.spectral_density(params, eigval)
        if nystrom_correction:
            gb2 = torch.square(self.graphbandwidth(params).reshape(()))
            density = density / torch.square(1.0 - gb2 * eigval)
        return density / torch.sum(density)

    def features_train(self, params, basis):
        """In-sample spectral features for the graph nodes themselves."""
        eigval, eigvec = basis
        density = self._normalized_density(params, eigval, nystrom_correction=False)
        return torch.sqrt(density * eigvec.shape[0])[None, :] * eigvec

    def features_test(self, params, basis, x):
        """Out-of-sample features via the Nystrom extension + bump window."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        edge_sqdist, edge_idx = self.knn.search(x, self.nearest_neighbors, self_query=False)
        return self._features_oos(params, basis, edge_sqdist, edge_idx)

    def _features_oos(self, params, basis, edge_sqdist, edge_idx):
        eigval, eigvec = basis
        gb = self.graphbandwidth(params).reshape(())
        dist0 = torch.sqrt(edge_sqdist[:, 0])
        within = dist0 < self.bump_scale * gb
        density = self._normalized_density(params, eigval, nystrom_correction=True)
        density = density * eigvec.shape[0]
        c = self.coeffs(params)
        ext = out_of_sample(
            self.graph, c, eigvec, edge_sqdist, edge_idx, gb,
            self.laplacian_normalization,
        )
        window = bump_function(dist0, self.bump_scale * gb, self.bump_decay)
        feats = torch.sqrt(density)[None, :] * ext * window[:, None]
        return torch.where(within[:, None], feats, torch.zeros_like(feats))

    def features(self, params, basis, x, is_train: Optional[bool] = None):
        """In-sample vs out-of-sample dispatch; with ``is_train=None`` the
        check is object identity with the kernel's own ``x``."""
        if is_train is None:
            is_train = x is self.x
        if is_train:
            return self.features_train(params, basis)
        return self.features_test(params, basis, x)

    def gram(self, params, basis, x1, x2=None, is_train1=None, is_train2=None):
        """Covariance k(x1, x2) from spectral features (no outputscale)."""
        z1 = self.features(params, basis, x1, is_train=is_train1)
        z2 = z1 if x2 is None else self.features(params, basis, x2, is_train=is_train2)
        return z1 @ z2.T

    # -- abstract ----------------------------------------------------------
    def spectral_density(self, params, eigval):
        raise NotImplementedError


class RiemannMaternKernel(RiemannKernel):
    """Matérn kernel through the graph-Laplacian spectrum."""

    def __init__(self, nu: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.nu = int(nu)

    def spectral_density(self, params, eigval):
        ls2 = torch.square(self.lengthscale(params).reshape(()))
        return torch.pow(2.0 * self.nu / ls2 + eigval, -float(self.nu))

    def precision_diag(self, params, coeffs=None):
        """(Approximate) diag(Q) for Jacobi PCG (ops.matern.matern_precision_diag)."""
        from ..ops.matern import matern_precision_diag

        c = self.coeffs(params) if coeffs is None else coeffs
        return matern_precision_diag(
            self.graph, c, self.nu, self.lengthscale(params),
            self.laplacian_normalization,
        )

    def precision_matvec(self, params, coeffs=None, permuted_io: bool = False):
        """The operator Q = (2 nu / l^2 I + L)^nu (an ``ops.operator.Operator``).

        With ``permuted_io=True`` (block path only) it works on
        padded-RCM-space vectors so compositions/solves built on top do no
        per-matvec permutation gathers."""
        from ..ops.matern import make_matern_precision_matvec

        c = self.coeffs(params) if coeffs is None else coeffs
        # The fused block path assembles *shifted* panels itself: pass the
        # layout plus the panel type, not an unshifted panel buffer.
        dense, block = None, None
        if self.use_dense_operator:
            dense = laplacian_dense(self.graph, c)
        elif self.block_layout is not None:
            block = (self.block_layout, _panel_dtype_of(self.cfg))
        if block is None:
            permuted_io = False
        return make_matern_precision_matvec(
            self.graph, c, self.nu, self.lengthscale(params),
            self.laplacian_normalization, dense=dense, block=block,
            permuted_io=permuted_io, grad_space=self.cfg.solve_cotangent,
        )
