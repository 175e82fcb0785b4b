"""Riemann (graph-spectral) kernels (port of ``manifold_gp_tpu.kernels.riemann``).

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

Multi-GPU (``mesh=``, a ``parallel.mesh.Mesh``): the kernel row-shards the
fused RCM block-ELL layout over the mesh (``parallel.block_spmv``), or,
when the graph is not block-sparse enough or ``use_block_sparse=False``,
the ELL gather scan (``parallel.spmv``). Its training operator then lives
in the padded row space (``n_padded`` rows, RCM-permuted on the fused path;
``mesh_rows_np`` maps a node to its row, ``embed_mesh_coeff`` embeds a
per-node vector), of which each rank holds ``mesh_row_range``. The basis is
block LOBPCG (or Chebyshev) on the row-sharded Laplacian with the padding
rows pinned at the Gershgorin bound, gathered to every rank and unpermuted
to node order; ``eigensolver="host_f64"`` raises on a mesh (the f64
shift-invert solver is single-device).
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
from ..parallel.mesh import in_probe_role
from ..parameters import ConstrainedParam, Positive


def _matrix_free_smallest(cfg, matvec, n_rows, m, bound, device, embed=None):
    """cfg-dispatched large-N basis solver: block LOBPCG (the default) or
    Chebyshev-filtered subspace iteration. Both draw their start block from
    an explicit generator with seed 0 at [n_rows, .]; the Chebyshev path
    oversamples the block by ~25% and slices back. On a mesh ``embed`` maps
    the node-order draw to this rank's rows of the padded space, so the
    mesh starts from the single-device block."""
    generator = torch.Generator(device=device).manual_seed(0)

    def start(width):
        x0 = torch.randn((n_rows, width), generator=generator, dtype=torch.float32,
                         device=device)
        return x0 if embed is None else embed(x0)

    if cfg.eigensolver != "chebyshev":
        return lobpcg_smallest(matvec, start(m), bound, max_iter=cfg.eigensolver_max_iter)
    mb = min(m + max(8, m // 4), n_rows)
    x0 = start(mb)
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
        mesh=None,
        graph=None,
        knn_index=None,
        device="cuda",
    ):
        self.device = mesh.device if mesh is not None else resolve_device(device)
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
        # (a mesh kernel builds its own row-sharded layout below)
        if not self.use_dense_operator and cfg.use_block_sparse and mesh is None:
            from ..ops.sparse_formats import build_layout

            self.block_layout = build_layout(
                self.graph, dia_max_offsets=cfg.dia_max_offsets, use_dia=cfg.use_dia
            )
        self.mesh = mesh
        self._sharded_tables = None
        self._mesh_fused = None
        if mesh is not None:
            if cfg.use_block_sparse:
                from ..parallel.block_spmv import build_mesh_block_tables

                self._mesh_fused = build_mesh_block_tables(self.graph, mesh)
            if self._mesh_fused is None:
                from ..parallel.spmv import shard_graph_rows

                self._sharded_tables = shard_graph_rows(self.graph, mesh)

    # -- the row-sharded vector space (mesh kernels) -------------------------
    @property
    def n_padded(self) -> int:
        """Row count of the padded row-sharded vector space (the node count
        on one device)."""
        if self.mesh is None:
            return self.graph.num_nodes
        if self._mesh_fused is not None:
            return self._mesh_fused.rows
        return self._sharded_tables[3]

    @property
    def mesh_row_range(self):
        """(first row, row count) of this rank's rows of the padded space."""
        if self.mesh is None:
            return 0, self.graph.num_nodes
        chunk = self.n_padded // self.mesh.world_size
        return self.mesh.rank * chunk, chunk

    @property
    def mesh_rows_np(self):
        """Host map node id -> padded row (RCM position on the fused path,
        identity on the scan path)."""
        import numpy as np

        if self._mesh_fused is not None:
            return self._mesh_fused.row_of_node_np
        return np.arange(self.graph.num_nodes)

    @property
    def mesh_rows(self):
        """Device copy of ``mesh_rows_np``."""
        if self._mesh_fused is not None:
            return self._mesh_fused.row_of_node
        return torch.arange(self.graph.num_nodes, device=self.device)

    def embed_mesh_coeff(self, d, fill: float = 0.0):
        """[N] per-node tensor -> this rank's rows of its padded embedding
        (``fill`` on padding rows); differentiable in ``d``."""
        if self._mesh_fused is not None:
            return self._mesh_fused.gather_coeff(d, fill=fill)
        lo, count = self.mesh_row_range
        pad = self.n_padded - d.shape[0]
        return torch.nn.functional.pad(d, (0, pad), value=fill)[lo:lo + count]

    def embed_mesh_rows(self, values):
        """[N, ...] node-order tensor -> this rank's rows of its padded
        embedding (zero on padding rows)."""
        if self._mesh_fused is not None:
            sh = self._mesh_fused.local
            return values[sh.perm_rows] * sh.row_mask.reshape(
                (-1,) + (1,) * (values.dim() - 1))
        lo, count = self.mesh_row_range
        pad = self.n_padded - values.shape[0]
        out = torch.cat([values, values.new_zeros((pad,) + tuple(values.shape[1:]))])
        return out[lo:lo + count]

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
    @in_probe_role
    @torch.no_grad()
    def eval_basis(self, params):
        """(eigval [m], eigvec [N, m]) of the graph Laplacian, with the
        reference's truncation and randomwalk-recovery post-processing."""
        if self.cfg.eigensolver == "host_f64":
            if self.mesh is not None:
                raise ValueError("eigensolver='host_f64' is a single-device solver; a mesh "
                                 "kernel solves its basis with 'lobpcg' or 'chebyshev'")
            return self._eval_basis_host_f64(params)
        c = self.coeffs(params)
        n = self.graph.num_nodes
        m = min(self.num_modes, n)
        if self.mesh is not None:
            eigval, eigvec = self._eval_basis_mesh(c, m)
        elif n <= self.cfg.eigh_max_size:
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

    def _eval_basis_mesh(self, c, m):
        """The row-sharded basis: LOBPCG (or Chebyshev) on the padded
        Laplacian over the mesh's SpMV (f32 panels on the fused path), the
        padding rows pinned at the Gershgorin bound, the top of the shifted
        spectrum, so they never displace a wanted pair. The start block is
        the single-device draw at the support rows. Every rank then gathers
        the eigenvectors and takes them in node order."""
        from ..ops.laplacian import gershgorin_bound
        from ..parallel.mesh import all_gather_rows, use_mesh

        n = self.graph.num_nodes
        npad = self.n_padded
        lo, count = self.mesh_row_range
        bound = gershgorin_bound(self.graph, c)
        if self._mesh_fused is not None:
            from ..parallel.block_spmv import assemble_sharded, make_sharded_block_matvec_ad

            tables = self._mesh_fused
            mask = tables.local.row_mask
            blocks = assemble_sharded(tables, c.diag, c.triu)
            mv = make_sharded_block_matvec_ad(tables)

            def lap_mv_pad(v):
                return mask * mv(blocks, v) + bound * (1.0 - mask) * v
        else:
            from ..parallel.spmv import sharded_adjacency_matvec

            ee, ec, em, _ = self._sharded_tables
            pad = npad - n
            diag_p = torch.nn.functional.pad(c.diag, (0, pad))[lo:lo + count]
            mask = (torch.arange(lo, lo + count, device=self.device) < n).to(
                torch.float32)[:, None]

            def lap_mv_pad(v):
                lv = diag_p[:, None] * v - sharded_adjacency_matvec(ee, ec, em, c.triu, v,
                                                                   self.mesh)
                return mask * lv + bound * (1.0 - mask) * v

        with use_mesh(self.mesh):
            eigval, eigvec = _matrix_free_smallest(self.cfg, lap_mv_pad, n, m, bound,
                                                   self.device, embed=self.embed_mesh_rows)
            eigvec = all_gather_rows(eigvec)
        if self._mesh_fused is not None:
            return eigval, eigvec[self._mesh_fused.row_of_node]
        return eigval, eigvec[:n]

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
        # an injected index may search on another device (a mesh's)
        return self._features_oos(params, basis, edge_sqdist.to(self.device),
                                  edge_idx.to(self.device))

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
        per-matvec permutation gathers.

        On a mesh kernel: the row-sharded operator on this rank's rows of
        the padded space (zero padding rows), bf16 panels when
        ``spmv_dtype="bfloat16"``, edge- or panel-space cotangents per
        ``solve_cotangent``."""
        from ..ops.matern import make_matern_precision_matvec

        c = self.coeffs(params) if coeffs is None else coeffs
        if self.mesh is not None:
            if self._mesh_fused is not None:
                from ..parallel.block_spmv import make_sharded_matern_precision_matvec_fused

                return make_sharded_matern_precision_matvec_fused(
                    self._mesh_fused, c, self.nu, self.lengthscale(params),
                    self.laplacian_normalization,
                    dtype=torch.bfloat16 if self.cfg.spmv_dtype == "bfloat16" else None,
                    grad_space=self.cfg.solve_cotangent,
                )
            from ..parallel.spmv import make_sharded_matern_precision_matvec

            mv, _ = make_sharded_matern_precision_matvec(
                self.graph, self.mesh, c, self.nu, self.lengthscale(params),
                self.laplacian_normalization, tables=self._sharded_tables,
            )
            return mv
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
