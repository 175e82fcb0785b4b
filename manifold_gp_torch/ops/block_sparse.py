"""Block-sparse (block-ELL) Laplacian layout and its plain matvec (port of
``manifold_gp_tpu.ops.block_sparse``).

Nodes are reordered on the host with reverse Cuthill-McKee (scipy), which
clusters each row's neighbours into a few 128-wide column blocks. The static
layout stores, per 128-row block, its <= S nonzero column blocks plus flat
scatter indices that place every directed edge value and every diagonal
entry into a panel buffer [nrb, 128, S*128]; ``assemble`` scatters the
current coefficients into it, and a matvec is one row permutation, one
coarse gather of the operand and one batched [128, S*128] @ [S*128, B]
product per row block. The arrays equal the JAX builder's element for
element (same RCM order, same slot order); the per-edge Python loops of the
JAX builder are vectorized here.

The product itself (the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors) is ``ops.cuda_spmv.matvec``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .graph import SparseGraph

BLOCK = 128


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static block-ELL structure of a symmetric graph Laplacian.

    ``block_col`` is int32, the type the CUDA kernel reads; the other index
    tables are int64 for torch indexing. Converted once, here."""

    perm: torch.Tensor  # [Np] int64: permuted_v[new] = v[perm[new]]
    unperm: torch.Tensor  # [N] int64: out[old] = permuted_out[unperm[old]]
    block_col: torch.Tensor  # [nrb, S] int32 column-block ids (0 = padding)
    edge_flat: torch.Tensor  # [2M] int64 flat panel index per directed edge
    diag_flat: torch.Tensor  # [N] int64 flat panel index per node diagonal
    num_nodes: int
    num_padded: int
    num_row_blocks: int
    max_blocks: int  # S

    def __post_init__(self):
        if tuple(self.block_col.shape) != (self.num_row_blocks, self.max_blocks):
            raise ValueError(f"BlockLayout: block_col shape {tuple(self.block_col.shape)} "
                             f"!= ({self.num_row_blocks}, {self.max_blocks})")
        check_block_cols(self.block_col, self.num_row_blocks)

    @property
    def panel_elems(self) -> int:
        return self.num_padded * self.max_blocks * BLOCK


def check_block_cols(block_col: torch.Tensor, num_col_blocks: int):
    """Raise unless every column-block id lies in [0, num_col_blocks): the
    CUDA kernel reads the operand at these ids unchecked. One device sync."""
    lo, hi = (int(t) for t in torch.aminmax(block_col))
    if lo < 0 or hi >= num_col_blocks:
        raise ValueError(f"block_col ids span [{lo}, {hi}], outside the operand's "
                         f"{num_col_blocks} column blocks")


def build_block_layout(graph: SparseGraph, max_blocks_cap: int = 40,
                       device=None) -> Optional[BlockLayout]:
    """Host-side construction: RCM ordering + block-ELL structure, on
    ``device`` (default: the graph's). Returns None when some row block
    needs more than ``max_blocks_cap`` column blocks."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    device = graph.device if device is None else device
    n = graph.num_nodes
    r = graph.rows.cpu().numpy().astype(np.int64)
    c = graph.cols.cpu().numpy().astype(np.int64)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    adj = coo_matrix(
        (np.ones(rr.shape[0], np.float32), (rr, cc)), shape=(n, n)
    ).tocsr()
    perm_old = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64)
    inv = np.empty(n, np.int64)
    inv[perm_old] = np.arange(n)

    npad = -(-n // BLOCK) * BLOCK
    nrb = npad // BLOCK
    pr, pc = inv[rr], inv[cc]  # directed edges in new order

    # per row block: sorted unique column blocks, the diagonal always present
    diag_keys = np.arange(nrb, dtype=np.int64) * (nrb + 1)
    keys = np.unique(np.concatenate([(pr // BLOCK) * nrb + pc // BLOCK, diag_keys]))
    key_rb, key_cb = keys // nrb, keys % nrb
    counts = np.bincount(key_rb, minlength=nrb)
    s_max = int(counts.max())
    if s_max > max_blocks_cap:
        return None
    starts = np.zeros(nrb, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    key_slot = np.arange(keys.shape[0], dtype=np.int64) - starts[key_rb]
    block_col = np.zeros((nrb, s_max), np.int64)
    block_col[key_rb, key_slot] = key_cb

    # flat index of a (new-order) entry (i, j) in the panel buffer
    # [nrb, BLOCK, S*BLOCK]
    def flat_idx(pi, pj):
        slots = key_slot[np.searchsorted(keys, (pi // BLOCK) * nrb + pj // BLOCK)]
        return pi * (s_max * BLOCK) + slots * BLOCK + pj % BLOCK

    edge_flat = flat_idx(pr, pc)
    pd = inv[np.arange(n, dtype=np.int64)]
    diag_flat = flat_idx(pd, pd)
    perm = np.concatenate([perm_old, np.zeros(npad - n, np.int64)])

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return BlockLayout(
        perm=dev(perm),
        unperm=dev(inv),
        block_col=dev(block_col, torch.int32),
        edge_flat=dev(edge_flat),
        diag_flat=dev(diag_flat),
        num_nodes=n,
        num_padded=int(npad),
        num_row_blocks=int(nrb),
        max_blocks=s_max,
    )


def assemble(layout: BlockLayout, diag: torch.Tensor, triu: torch.Tensor,
             dtype=None):
    """Scatter the current Laplacian coefficients (L = diag - A_sym) into the
    panel buffer [nrb, BLOCK, S*BLOCK].

    ``dtype``: None/torch.float32 (exact), torch.bfloat16, or "float32x3":
    the f32 panels split into stacked (hi, lo) bf16 [2, nrb, BLOCK, S*BLOCK]
    with hi = bf16(x), lo = bf16(x - hi). Edge and diagonal slots are
    disjoint, so one scatter-set places every value."""
    vals = torch.cat([-triu, -triu, diag])
    idx = torch.cat([layout.edge_flat, layout.diag_flat])
    shape = (layout.num_row_blocks, BLOCK, layout.max_blocks * BLOCK)
    if dtype == "float32x3":
        from .cuda_spmv import split_bf16x3

        flat = torch.zeros(layout.panel_elems, dtype=diag.dtype, device=diag.device)
        flat[idx] = vals
        return split_bf16x3(flat.reshape(shape))
    # Scatter in the target dtype: casting the coefficient vectors loses the
    # same bits as casting assembled panels, without a second f32 buffer.
    buf_dtype = diag.dtype if dtype is None else dtype
    flat = torch.zeros(layout.panel_elems, dtype=buf_dtype, device=diag.device)
    flat[idx] = vals.to(buf_dtype)
    return flat.reshape(shape)


def permute_in(layout: BlockLayout, v: torch.Tensor) -> torch.Tensor:
    """[N, B] original order -> [Np, B] RCM order with zeroed padding rows."""
    pv = v[layout.perm]
    if layout.num_padded > layout.num_nodes:
        pv[layout.num_nodes:] = 0.0
    return pv


def permute_out(layout: BlockLayout, pv: torch.Tensor) -> torch.Tensor:
    """[Np, B] RCM order -> [N, B] original order."""
    return pv[layout.unperm]
