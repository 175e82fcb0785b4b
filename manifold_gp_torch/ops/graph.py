"""Symmetric kNN graph construction (port of ``manifold_gp_tpu.ops.graph``).

Same edge-list semantics as the JAX builder: search k neighbours including
the self-match, drop column 0, orient every directed edge upper-triangular,
merge duplicate pairs with a mean, and recompute the stored edge values by
coordinate differencing. The coalesce and the padded ELL table are host
numpy (the same code as the JAX package, so edge order and slots are
identical); the finished graph lives on the caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from .knn import knn_search


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Static structure of a symmetric kNN graph.

    COO fields hold the coalesced upper-triangular edge list; ELL fields hold
    the per-node incident-edge table used by the gather SpMV. Index tensors
    are int64 (torch's indexing type)."""

    rows: torch.Tensor  # [M] int64, row < col
    cols: torch.Tensor  # [M] int64
    sqdist: torch.Tensor  # [M] float32 squared L2 edge lengths
    mask: torch.Tensor  # [M] float32, 1 = valid edge
    ell_edge: torch.Tensor  # [N, D] int64 index into the edge arrays
    ell_col: torch.Tensor  # [N, D] int64 neighbour node id
    ell_mask: torch.Tensor  # [N, D] float32
    num_nodes: int
    max_degree: int

    @property
    def num_edges(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sqdist.device


def coalesce_mean(rows, cols, vals, num_nodes):
    """Merge duplicate (row, col) pairs, averaging their values. Host numpy;
    returns sorted COO (int32, int32, float32)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    key = rows * num_nodes + cols
    order = np.argsort(key, kind="stable")
    key_s, val_s = key[order], vals[order]
    boundary = np.empty(key_s.shape[0], bool)
    boundary[0] = True
    boundary[1:] = key_s[1:] != key_s[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(val_s, starts)
    counts = np.diff(np.append(starts, key_s.shape[0]))
    ukey = key_s[starts]
    return (
        (ukey // num_nodes).astype(np.int32),
        (ukey % num_nodes).astype(np.int32),
        (sums / counts).astype(np.float32),
    )


def _build_ell(rows, cols, num_nodes):
    """Padded per-node incident-edge table for the symmetric adjacency."""
    m = rows.shape[0]
    owners = np.concatenate([rows, cols])
    nbrs = np.concatenate([cols, rows])
    eids = np.concatenate([np.arange(m), np.arange(m)]).astype(np.int64)
    order = np.argsort(owners, kind="stable")
    owners, nbrs, eids = owners[order], nbrs[order], eids[order]
    counts = np.bincount(owners, minlength=num_nodes)
    max_degree = int(counts.max()) if m else 1
    offsets = np.zeros(num_nodes, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    slots = np.arange(owners.shape[0]) - offsets[owners]
    ell_edge = np.zeros((num_nodes, max_degree), np.int64)
    ell_col = np.zeros((num_nodes, max_degree), np.int64)
    ell_mask = np.zeros((num_nodes, max_degree), np.float32)
    ell_edge[owners, slots] = eids
    ell_col[owners, slots] = nbrs
    ell_mask[owners, slots] = 1.0
    return ell_edge, ell_col, ell_mask, max_degree


def graph_from_edges(rows, cols, sqdist, num_nodes, device=None) -> SparseGraph:
    """Assemble a SparseGraph from an already-coalesced triu edge list, which
    must be free of self-loops and duplicates (the block-ELL assembly keeps
    one slot per entry), on ``device`` (default: CUDA, which raises without
    a card)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    sqdist = np.asarray(sqdist, np.float32)
    if rows.size:
        if np.any(rows == cols):
            raise ValueError(
                "graph_from_edges: self-loop edges (row == col) are not "
                "allowed; drop the self-match column before assembling."
            )
        key = rows * int(num_nodes) + cols
        if np.unique(key).size != key.size:
            raise ValueError(
                "graph_from_edges: duplicate (row, col) pairs; coalesce the "
                "edge list first (see coalesce_mean)."
            )
    device = resolve_device("cuda") if device is None else device
    ell_edge, ell_col, ell_mask, max_degree = _build_ell(rows, cols, num_nodes)

    def dev(a):
        return torch.as_tensor(a).to(device)

    return SparseGraph(
        rows=dev(rows),
        cols=dev(cols),
        sqdist=dev(sqdist),
        mask=torch.ones(rows.shape[0], dtype=torch.float32, device=device),
        ell_edge=dev(ell_edge),
        ell_col=dev(ell_col),
        ell_mask=dev(ell_mask),
        num_nodes=int(num_nodes),
        max_degree=max_degree,
    )


def symmetrize_knn_edges(sqd, idx, num_nodes: int, x=None,
                         device=None) -> SparseGraph:
    """Drop the self column, orient upper-triangular, mean-coalesce, assemble
    on ``device`` (default: CUDA, which raises without a card).
    ``sqd``/``idx`` are the raw [N, k] self-query search results (host
    arrays). With ``x`` the stored edge values are recomputed exactly as
    ||x_r - x_c||^2 by coordinate differencing; the search's values serve
    only neighbour selection and the +inf missing-slot mask."""
    n = int(num_nodes)
    sqd = np.asarray(sqd)[:, 1:]
    idx = np.asarray(idx)[:, 1:]
    k_eff = sqd.shape[1]
    rows = np.repeat(np.arange(n, dtype=np.int64), k_eff)
    cols = idx.reshape(-1).astype(np.int64)
    vals = sqd.reshape(-1)
    finite = np.isfinite(vals)
    if not finite.all():
        rows, cols, vals = rows[finite], cols[finite], vals[finite]
    flip = ~(cols > rows)
    r2 = np.where(flip, cols, rows)
    c2 = np.where(flip, rows, cols)
    ur, uc, uv = coalesce_mean(r2, c2, vals, n)
    if x is not None:
        xh = np.asarray(x, np.float32)
        d = xh[ur] - xh[uc]
        uv = np.einsum("ij,ij->i", d, d).astype(np.float32)
    return graph_from_edges(ur, uc, uv, n, device=device)


def build_graph(x, nearest_neighbors: int, knn_backend: str = "device",
                device=None) -> SparseGraph:
    """kNN graph with the reference's construction semantics. The search runs
    on ``device`` (default: the device of ``x`` when it is a tensor, else
    CUDA, which raises without a card); only the exact device search is
    ported."""
    if knn_backend != "device":
        raise NotImplementedError(
            f"build_graph(knn_backend={knn_backend!r}): only the exact "
            "'device' search is ported (host and IVF backends: ROADMAP queue 1, "
            "'Large-N ancillaries')"
        )
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else resolve_device("cuda")
    xt = torch.as_tensor(x, dtype=torch.float32).to(device)
    sqd, idx = knn_search(xt, xt, nearest_neighbors, self_query=True)
    return symmetrize_knn_edges(
        sqd.cpu().numpy(), idx.cpu().numpy(), xt.shape[0],
        x=xt.cpu().numpy(), device=device,
    )
