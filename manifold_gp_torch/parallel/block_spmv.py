"""Row-sharded fused block-ELL SpMV, the multi-GPU hot path (port of
``manifold_gp_tpu.parallel.block_spmv``).

  * The global RCM block-ELL layout (``ops.block_sparse.build_block_layout``)
    is built once on the host; its row blocks are padded to a count the world
    size divides, and rank r owns the contiguous row blocks
    [r * lrb, (r + 1) * lrb) and the same rows of every vector.
  * Panel assembly is per shard: each rank scatters exactly the (directed)
    edges and diagonals of its own rows, from the replicated coefficient
    vectors, into its local panels [lrb, 128, S*128]: no traffic.
  * Each matvec exchanges the operand (``_exchange``) and runs the forward
    kernel (K1/K2, ``ops.cuda_spmv``) on the local panels against the
    exchanged window (``_local_matvec``); the panel cotangent is K3 on the
    local cotangent rows against the same window (``_local_bwd_blocks``).
    The local compute makes no collective call.
  * One ``torch.autograd.Function`` wraps the whole sharded matvec:
    bar_pv is one more sharded matvec (the globally assembled operator is
    symmetric: both edge directions and the diagonal are scattered), and
    the panel cotangent is this rank's K3. Defining the backward at the
    operator level keeps the symmetric-adjoint trick valid (a local row
    slice of L_sym is not symmetric on its own).

The exchange, with ``tables.halo`` = h column blocks (each rank's panels
read only columns within h blocks of its own range): one ``all_gather`` of
every rank's two boundary slices [h*128, B], of which each rank keeps its
ring neighbours' (a window of lrb + 2h blocks: 2*h*128*B bytes a matvec per
rank, where the full gather moves (ws-1)/ws of the operand); else
(``halo`` None, or ``exchange="gather"``) an ``all_gather`` of the whole
operand. Both backends run ``all_gather`` on CUDA tensors; gloo has no CUDA
send/recv, so JAX's ppermute is not translated to send/recv.

Vectors live in the permuted padded row space (RCM order, zero padding
rows); ``MeshBlockTables.row_of_node`` maps a node to its row, so the hot
loop makes no per-matvec permutation. The K1/K2 residency choice and JAX's
``impl`` / ``interpret`` switches have no counterpart: the device alone
picks the kernel (CUDA tensors) or its plain version (CPU tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import cuda_spmv
from ..ops.block_sparse import BLOCK, build_block_layout, check_block_cols
from ..ops.graph import SparseGraph
from ..ops.operator import Operator
from .mesh import Mesh, enter_sharded


@dataclasses.dataclass(frozen=True, eq=False)
class ShardTables:
    """One rank's device tables: its rows [row_lo, row_lo + lrows), its
    block ids (global for the gather exchange, window-relative for the halo
    exchange; each checked once against its operand), its assembly entries
    and its slices of the permuted-row maps."""

    rank: int
    lrb: int
    row_lo: int
    lrows: int
    block_col: torch.Tensor  # [lrb*S] int32 global column-block ids
    block_col_halo: Optional[torch.Tensor]  # [lrb*S] int32 window ids (halo only)
    window_blocks: int  # lrb + 2*halo (halo exchange)
    edge_sel: torch.Tensor  # [E_r] int64 edge id into triu
    edge_pos: torch.Tensor  # [E_r] int64 local flat panel position
    diag_sel: torch.Tensor  # [N_r] int64 node id
    diag_pos: torch.Tensor  # [N_r] int64 local flat panel position
    perm_rows: torch.Tensor  # [lrows] int64 node at each row (0 on padding)
    row_mask: torch.Tensor  # [lrows, 1] f32: 1 real row, 0 padding


@dataclasses.dataclass(frozen=True, eq=False)
class MeshBlockTables:
    """Static row-sharded block-ELL structure: the global host tables (the
    same arrays as JAX's for the same graph and world size) and this rank's
    device tables (``local``)."""

    mesh: Mesh
    s_max: int
    num_nodes: int
    nrb: int  # rank-divisible row-block count (>= the layout's)
    rows: int  # nrb * BLOCK: the padded permuted row space
    block_col_np: np.ndarray  # [nrb, S] int32
    # per-rank assembly tables [ndev, W], -1 / lsize on padding entries:
    edge_sel_np: np.ndarray
    edge_pos_np: np.ndarray
    diag_sel_np: np.ndarray
    diag_pos_np: np.ndarray
    perm_np: np.ndarray  # [rows] node id at each row (0 on padding rows)
    row_mask_np: np.ndarray  # [rows] 1.0 real row / 0.0 padding
    row_of_node_np: np.ndarray  # [N] padded row of each node
    row_of_node: torch.Tensor  # [N] int64, replicated, on the mesh's device
    # Halo width in column blocks: every rank's column blocks lie within
    # (modular) distance ``halo`` of its own row-block range. None when
    # some rank needs columns beyond its ring neighbours (the exchange then
    # gathers the whole operand).
    halo: Optional[int]
    local: ShardTables = None

    @property
    def ndev(self) -> int:
        return self.mesh.world_size

    @property
    def lrb(self) -> int:
        return self.nrb // self.ndev

    def embed_rows(self, values, node_idx=None, fill: float = 0.0) -> torch.Tensor:
        """[N(idx)]-indexed host values -> this rank's rows of the permuted
        padded array, on the mesh's device."""
        values = np.asarray(values)
        out = np.full((self.rows,) + values.shape[1:], fill, values.dtype)
        rows = self.row_of_node_np if node_idx is None else self.row_of_node_np[node_idx]
        out[rows] = values
        sh = self.local
        return torch.from_numpy(out[sh.row_lo:sh.row_lo + sh.lrows]).to(self.mesh.device)

    def gather_coeff(self, coeff: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """[N] per-node tensor -> this rank's rows of its permuted padded
        embedding (``fill`` on padding rows); differentiable in ``coeff``."""
        sh = self.local
        vals = coeff[sh.perm_rows]
        return torch.where(sh.row_mask[:, 0] > 0, vals, torch.full_like(vals, fill))


def shard_tables(tables: MeshBlockTables, rank: int, device=None) -> ShardTables:
    """Rank ``rank``'s device tables of ``tables`` (any rank: a process can
    hold every shard's layout, as a single-device check of the shards
    does)."""
    device = tables.mesh.device if device is None else device
    lrb, s_max = tables.lrb, tables.s_max
    lo_b = rank * lrb
    bc = tables.block_col_np[lo_b:lo_b + lrb]

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    block_col = dev(bc.reshape(-1), torch.int32)
    check_block_cols(block_col, tables.nrb)
    halo_ids, window = None, lrb
    if tables.halo is not None:
        h = tables.halo
        window = lrb + 2 * h if (tables.ndev > 1 and h > 0) else lrb
        bcl = np.clip(np.mod(bc.astype(np.int64) - lo_b + h, tables.nrb), 0, window - 1)
        halo_ids = dev(bcl.reshape(-1), torch.int32)
        check_block_cols(halo_ids, window)
    es, ep = tables.edge_sel_np[rank], tables.edge_pos_np[rank]
    ds, dp = tables.diag_sel_np[rank], tables.diag_pos_np[rank]
    lrows = lrb * BLOCK
    row_lo = rank * lrows
    return ShardTables(
        rank=rank, lrb=lrb, row_lo=row_lo, lrows=lrows,
        block_col=block_col, block_col_halo=halo_ids, window_blocks=window,
        edge_sel=dev(es[es >= 0]), edge_pos=dev(ep[es >= 0]),
        diag_sel=dev(ds[ds >= 0]), diag_pos=dev(dp[ds >= 0]),
        perm_rows=dev(tables.perm_np[row_lo:row_lo + lrows]),
        row_mask=dev(tables.row_mask_np[row_lo:row_lo + lrows, None], torch.float32),
    )


def build_mesh_block_tables(graph: SparseGraph, mesh: Mesh,
                            max_blocks_cap: int = 40) -> Optional[MeshBlockTables]:
    """Host-side construction, with this rank's device tables. Returns None
    when the RCM-reordered graph is not block-sparse enough (callers fall
    back to the ELL gather scan of ``parallel.spmv``)."""
    layout = build_block_layout(graph, max_blocks_cap=max_blocks_cap, device="cpu")
    if layout is None:
        return None
    ndev = mesh.world_size
    n = graph.num_nodes
    s_max = layout.max_blocks
    nrb0 = layout.num_row_blocks
    nrb = -(-nrb0 // ndev) * ndev
    rows = nrb * BLOCK
    lrb = nrb // ndev
    lsize = lrb * BLOCK * s_max * BLOCK

    bc = np.zeros((nrb, s_max), np.int32)
    bc[:nrb0] = layout.block_col.numpy()

    # Per-rank assembly tables: the layout's edge_flat covers both directed
    # edge copies ([2M]: triu, then its transpose), diag_flat the N node
    # diagonals; each splits by owning rank (flat // lsize) into a table
    # padded with -1 ids at the dummy position lsize.
    ef = layout.edge_flat.numpy().astype(np.int64)
    df = layout.diag_flat.numpy().astype(np.int64)
    m2 = ef.shape[0]
    eid = np.arange(m2, dtype=np.int64) % (m2 // 2)
    nid = np.arange(n, dtype=np.int64)

    def split(flat, ids):
        owner = flat // lsize
        sel_rows = [ids[owner == d] for d in range(ndev)]
        pos_rows = [flat[owner == d] - d * lsize for d in range(ndev)]
        width = max(1, max(r.shape[0] for r in sel_rows))
        sel = np.full((ndev, width), -1, np.int32)
        pos = np.full((ndev, width), lsize, np.int32)
        for d in range(ndev):
            sel[d, :sel_rows[d].shape[0]] = sel_rows[d]
            pos[d, :pos_rows[d].shape[0]] = pos_rows[d]
        return sel, pos

    edge_sel, edge_pos = split(ef, eid)
    diag_sel, diag_pos = split(df, nid)

    perm_np = np.zeros(rows, np.int64)
    perm_np[:layout.num_padded] = layout.perm.numpy()
    row_of_node_np = layout.unperm.numpy().astype(np.int64)
    row_mask_np = np.zeros(rows, np.float32)
    row_mask_np[row_of_node_np] = 1.0

    # Halo: the least H (in column blocks) such that every rank's needed
    # blocks lie within modular distance H of its own range. Unused slots
    # of short rows point at block 0 with zero panel columns, so they are
    # left out of the need set (trailing repeats of the slot-0 id).
    used = np.zeros((nrb, s_max), bool)
    used[:nrb0] = True
    nz = np.count_nonzero(np.diff(bc[:nrb0], axis=1) > 0, axis=1) + 1
    used[:nrb0] &= np.arange(s_max)[None, :] < nz[:, None]
    halo = 0
    for d in range(ndev):
        own_lo, own_hi = d * lrb, (d + 1) * lrb - 1
        needed = np.unique(bc[own_lo:own_hi + 1][used[own_lo:own_hi + 1]])
        out = needed[(needed < own_lo) | (needed > own_hi)].astype(np.int64)
        if out.size:
            left = (own_lo - out) % nrb
            right = (out - own_hi) % nrb
            halo = max(halo, int(np.minimum(left, right).max()))
    tables = MeshBlockTables(
        mesh=mesh, s_max=s_max, num_nodes=n, nrb=int(nrb), rows=int(rows),
        block_col_np=bc, edge_sel_np=edge_sel, edge_pos_np=edge_pos,
        diag_sel_np=diag_sel, diag_pos_np=diag_pos, perm_np=perm_np,
        row_mask_np=row_mask_np, row_of_node_np=row_of_node_np,
        row_of_node=torch.from_numpy(row_of_node_np).to(mesh.device),
        halo=halo if halo <= lrb else None,
    )
    object.__setattr__(tables, "local", shard_tables(tables, mesh.rank))
    return tables


def assemble_sharded(tables: MeshBlockTables, diag: torch.Tensor, triu: torch.Tensor,
                     dtype=None, shard: ShardTables = None):
    """Scatter the Laplacian coefficients (L = diag - A_sym) into this rank's
    panels [lrb, 128, S*128] (``shard``'s, when given) from the replicated
    coefficient vectors; differentiable in (diag, triu). ``dtype`` as
    ``ops.block_sparse.assemble``: None (f32), torch.bfloat16 or
    "float32x3"."""
    sh = tables.local if shard is None else shard
    shape = (sh.lrb, BLOCK, tables.s_max * BLOCK)
    vals = torch.cat([-triu[sh.edge_sel], diag[sh.diag_sel]])
    idx = torch.cat([sh.edge_pos, sh.diag_pos])
    buf_dtype = diag.dtype if dtype in (None, "float32x3") else dtype
    flat = torch.zeros(int(np.prod(shape)), dtype=buf_dtype, device=diag.device)
    flat[idx] = vals.to(buf_dtype)
    if dtype == "float32x3":
        return cuda_spmv.split_bf16x3(flat.reshape(shape))
    return flat.reshape(shape)


# -- local compute (no collective) -------------------------------------------


def _local_matvec(tables: MeshBlockTables, ids, blocks, window, num_col_blocks: int):
    """Local panels x exchanged window -> this rank's rows [lrb*128, B]."""
    return cuda_spmv.window_matvec_call(ids, blocks, window.contiguous(), s_max=tables.s_max,
                                        num_col_blocks=num_col_blocks)


def _local_bwd_blocks(tables: MeshBlockTables, ids, g, window, num_col_blocks: int,
                      out_dtype):
    """Local panel cotangent bar_blocks[r] = g_local[r] @ window[r]^T."""
    return cuda_spmv.window_bwd_blocks_call(ids, g.contiguous(), window.contiguous(),
                                            s_max=tables.s_max,
                                            num_col_blocks=num_col_blocks,
                                            out_dtype=out_dtype)


# -- the exchange -------------------------------------------------------------


def _exchange(tables: MeshBlockTables, pvb, force_gather: bool):
    """This rank's operand rows pvb [lrb*128, B] -> (window operand, its
    block ids, its column-block count)."""
    mesh, sh = tables.mesh, tables.local
    if force_gather or tables.halo is None:
        return mesh.all_gather(pvb), sh.block_col, tables.nrb
    h = tables.halo
    if tables.ndev > 1 and h > 0:
        width = h * BLOCK
        ends = mesh.all_gather(torch.cat([pvb[:width], pvb[-width:]]))
        ends = ends.reshape(tables.ndev, 2, width, pvb.shape[1])
        left = ends[(mesh.rank - 1) % tables.ndev, 1]  # the left neighbour's tail
        right = ends[(mesh.rank + 1) % tables.ndev, 0]  # the right neighbour's head
        window = torch.cat([left, pvb, right])
    else:
        window = pvb
    return window, sh.block_col_halo, sh.window_blocks


def exchange_name(tables: MeshBlockTables, exchange: str = "auto") -> str:
    """The schedule a matvec takes: "halo" or "gather"."""
    return "gather" if (exchange == "gather" or tables.halo is None) else "halo"


def _apply(tables, force_gather, blocks, pv):
    window, ids, ncb = _exchange(tables, pv.contiguous(), force_gather)
    return _local_matvec(tables, ids, blocks, window, ncb)


class _ShardedBlockMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, force_gather, blocks, pv):
        ctx.tables, ctx.force_gather = tables, force_gather
        ctx.save_for_backward(blocks, pv)
        return _apply(tables, force_gather, blocks, pv)

    @staticmethod
    def backward(ctx, g):
        blocks, pv = ctx.saved_tensors
        tables, force_gather = ctx.tables, ctx.force_gather
        g = g.to(pv.dtype).contiguous()
        bar_blocks = bar_pv = None
        if ctx.needs_input_grad[3]:
            bar_pv = _apply(tables, force_gather, blocks, g)
        if ctx.needs_input_grad[2]:
            x3 = cuda_spmv._is_x3(blocks)
            window, ids, ncb = _exchange(tables, pv, force_gather)
            bar_blocks = _local_bwd_blocks(
                tables, ids, g, window, ncb, torch.bfloat16 if x3 else blocks.dtype)
            if x3:
                bar_blocks = torch.stack([bar_blocks, bar_blocks], dim=0)
        return None, None, bar_blocks, bar_pv


class _ShardedBlockMatvecEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, force_gather, qblocks, diag, triu, pv):
        ctx.tables, ctx.force_gather = tables, force_gather
        ctx.sizes = (diag.shape[0], triu.shape[0])
        ctx.save_for_backward(qblocks, pv)
        return _apply(tables, force_gather, qblocks, pv)

    @staticmethod
    def backward(ctx, g):
        qblocks, pv = ctx.saved_tensors
        tables, force_gather = ctx.tables, ctx.force_gather
        sh = tables.local
        g = g.to(pv.dtype).contiguous()
        bar_diag = bar_triu = bar_pv = None
        if ctx.needs_input_grad[5]:
            bar_pv = _apply(tables, force_gather, qblocks, g)
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            window, ids, ncb = _exchange(tables, pv, force_gather)
            flat = _local_bwd_blocks(tables, ids, g, window, ncb, torch.float32).reshape(-1)
            n_nodes, n_edges = ctx.sizes
            # assemble scatters (-triu) at edge slots and (+diag) at
            # diagonals; each directed edge copy lives on one rank, and
            # enter_sharded sums the ranks' partial cotangents
            bar_triu = flat.new_zeros(n_edges).index_add(0, sh.edge_sel, -flat[sh.edge_pos])
            bar_diag = flat.new_zeros(n_nodes).index_add(0, sh.diag_sel, flat[sh.diag_pos])
        return None, None, None, bar_diag, bar_triu, bar_pv


def make_sharded_block_matvec_ad(tables: MeshBlockTables, exchange: str = "auto"):
    """Differentiable row-sharded fused matvec ``mv(blocks, pv) -> L_sym @
    pv`` over this rank's rows of the permuted padded space, with
    panel-space cotangents. ``exchange``: "auto" (halo where the layout
    admits it, else gather) or "gather"."""
    force_gather = exchange == "gather"

    def mv(blocks, pv):
        return _ShardedBlockMatvec.apply(tables, force_gather, blocks, pv)

    return mv


def make_sharded_block_matvec_edge_ad(tables: MeshBlockTables, exchange: str = "auto"):
    """Row-sharded fused matvec with edge-space cotangents:
    ``mv(qblocks, diag, triu, pv)``, the mesh twin of
    ``ops.cuda_spmv.make_matvec_edge_ad``. Caller contract:
    ``qblocks == assemble_sharded(tables, diag, triu, dtype=...)``,
    detached. The backward contracts this rank's panel cotangent to the
    coefficient vectors by the transpose of ``assemble_sharded``'s scatter;
    the sum over ranks is ``enter_sharded``'s backward, where (diag, triu)
    entered the sharded computation."""
    force_gather = exchange == "gather"

    def mv(qblocks, diag, triu, pv):
        return _ShardedBlockMatvecEdge.apply(tables, force_gather, qblocks, diag, triu, pv)

    return mv


def _check_normalization(normalization: str):
    if normalization not in ("randomwalk", "symmetric"):
        raise ValueError("normalization must be 'randomwalk' or 'symmetric', got "
                         f"{normalization!r}")


def _entered_coeffs(tables: MeshBlockTables, coeffs, nu: int, lengthscale):
    """(diag + shift, triu, deg) as the sharded computation takes them: one
    ``enter_sharded`` for the three, so one all-reduce sums their partial
    cotangents."""
    ls = torch.as_tensor(lengthscale, dtype=torch.float32, device=coeffs.deg.device)
    shift = 2.0 * nu / torch.square(ls.reshape(()))
    n, m = coeffs.diag.shape[0], coeffs.triu.shape[0]
    shared = enter_sharded(torch.cat([coeffs.diag + shift, coeffs.triu, coeffs.deg]),
                           tables.mesh)
    return torch.split(shared, [n, m, n])


def sharded_matern_precision_operands(tables: MeshBlockTables, coeffs, nu: int, lengthscale,
                                      dtype=None, normalization: str = "randomwalk"):
    """The per-coefficient operands of the fused mesh Matérn matvec: this
    rank's shift-folded panels [lrb, 128, S*128] and its rows of the
    permuted sqrt-degree vector (None for the symmetric normalization)."""
    _check_normalization(normalization)
    diag_s, triu, deg = _entered_coeffs(tables, coeffs, nu, lengthscale)
    qblocks = assemble_sharded(tables, diag_s, triu, dtype=dtype)
    dsq_p = (torch.sqrt(tables.gather_coeff(deg, fill=1.0))
             if normalization == "randomwalk" else None)
    return qblocks, dsq_p


def make_sharded_matern_precision_matvec_operand(tables: MeshBlockTables, nu: int,
                                                 normalization: str = "randomwalk",
                                                 exchange: str = "auto"):
    """Operand-explicit fused mesh Matérn matvec ``matvec(qblocks, dsq_p,
    v)``, with operands from :func:`sharded_matern_precision_operands`."""
    _check_normalization(normalization)
    mv_ad = make_sharded_block_matvec_ad(tables, exchange=exchange)

    def matvec(qblocks, dsq_p, v):
        squeeze = v.dim() == 1
        out = v[:, None] if squeeze else v
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        for _ in range(nu):
            out = mv_ad(qblocks, out)
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        return out[:, 0] if squeeze else out

    return matvec


def make_sharded_matern_precision_matvec_fused(tables: MeshBlockTables, coeffs, nu: int,
                                               lengthscale, normalization: str = "randomwalk",
                                               dtype=None, grad_space: str = "panel",
                                               exchange: str = "auto") -> Operator:
    """Row-sharded fused Matérn precision Q = D^{1/2} (2 nu/l^2 I +
    L_sym)^nu D^{1/2} (randomwalk; symmetric drops the D factors), the shift
    folded into the panel diagonal so each of the nu inner applications is
    one sharded fused matvec. An ``Operator`` on this rank's rows [lrows, B]
    (zero padding rows: the padding degree fill 1.0 keeps them zero).

    ``grad_space``: "panel" (default) or "edge" (edge-space solve
    cotangents, ``make_sharded_block_matvec_edge_ad``; see
    ``InferenceConfig.solve_cotangent``)."""
    mesh = tables.mesh
    if grad_space == "edge":
        _check_normalization(normalization)
        diag_s, triu, deg = _entered_coeffs(tables, coeffs, nu, lengthscale)
        with torch.no_grad():
            qblocks = assemble_sharded(tables, diag_s, triu, dtype=dtype)
        mv_edge = make_sharded_block_matvec_edge_ad(tables, exchange=exchange)
        dsq_p = (torch.sqrt(tables.gather_coeff(deg, fill=1.0))
                 if normalization == "randomwalk" else None)

        def matvec(v, qblocks, diag_s, triu, *dsq):
            squeeze = v.dim() == 1
            out = v[:, None] if squeeze else v
            if dsq:
                out = out * dsq[0][:, None]
            for _ in range(nu):
                out = mv_edge(qblocks, diag_s, triu, out)
            if dsq:
                out = out * dsq[0][:, None]
            return out[:, 0] if squeeze else out

        consts = (qblocks, diag_s, triu) + (() if dsq_p is None else (dsq_p,))
        return Operator(matvec, consts, mesh=mesh)
    qblocks, dsq_p = sharded_matern_precision_operands(
        tables, coeffs, nu, lengthscale, dtype=dtype, normalization=normalization)
    inner = make_sharded_matern_precision_matvec_operand(tables, nu, normalization,
                                                         exchange=exchange)
    if dsq_p is None:
        return Operator(lambda v, qblocks: inner(qblocks, None, v), (qblocks,), mesh=mesh)
    return Operator(lambda v, qblocks, dsq_p: inner(qblocks, dsq_p, v), (qblocks, dsq_p),
                    mesh=mesh)
