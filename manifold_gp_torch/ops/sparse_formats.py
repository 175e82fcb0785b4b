"""Sparse-layout format dispatch (port of ``manifold_gp_tpu.ops.sparse_formats``).

The JAX package picks DIA bands when the RCM ordering is banded enough and
128x128 block-ELL panels otherwise. The DIA format (kernel K4) is not ported
yet, so ``build_layout`` raises whenever the JAX dispatch would have chosen
it; with ``use_dia=False`` every call lands on block-ELL panels, and
``matvec``, ``matvec_permuted`` and ``make_matvec_ad`` are those of
``ops.cuda_spmv``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import block_sparse
from .block_sparse import BlockLayout, assemble, permute_in, permute_out
from .cuda_spmv import block_matvec as matvec_permuted
from .cuda_spmv import make_matvec_ad, matvec
from .graph import SparseGraph

__all__ = ["build_layout", "assemble", "matvec", "matvec_permuted", "make_matvec_ad",
           "permute_in", "permute_out"]


# DIA constants of the JAX package (ops/dia.py): rows per kernel tile and
# the stored band width.
_DIA_TILE = 512
_DIA_BAND_WIDTH = 128


def _dia_would_apply(graph: SparseGraph, max_offsets: int) -> bool:
    """The condition under which the JAX ``build_dia_layout`` returns a
    layout: at most min(max_offsets, 128) distinct diagonal offsets
    (including 0) after RCM, a halfwidth within one 512-row tile, and
    n >= 2 * halfwidth."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = graph.num_nodes
    r = graph.rows.cpu().numpy().astype(np.int64)
    c = graph.cols.cpu().numpy().astype(np.int64)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    adj = coo_matrix((np.ones(rr.shape[0], np.float32), (rr, cc)), shape=(n, n)).tocsr()
    perm_old = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64)
    inv = np.empty(n, np.int64)
    inv[perm_old] = np.arange(n)
    offs = np.unique(np.concatenate([inv[cc] - inv[rr], np.zeros(1, np.int64)]))
    w = int(np.max(np.abs(offs)))
    return not (offs.size > min(max_offsets, _DIA_BAND_WIDTH) or w > _DIA_TILE
                or n < 2 * w)


def build_layout(
    graph: SparseGraph,
    max_blocks_cap: int = 40,
    dia_max_offsets: int = 24,
    use_dia: bool = True,
) -> Optional[BlockLayout]:
    """RCM-reorder the graph into block-ELL panels (None when the graph is not
    block-sparse enough). Raises where the JAX dispatch would pick DIA."""
    if use_dia and _dia_would_apply(graph, dia_max_offsets):
        raise NotImplementedError(
            "build_layout: this graph takes the DIA band format in the JAX "
            "package, which is not ported yet (kernel K4, ROADMAP queue 1, "
            "'DIA bands'); pass use_dia=False for block-ELL panels"
        )
    return block_sparse.build_block_layout(graph, max_blocks_cap=max_blocks_cap)
