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


def pin_self_match(sqd, idx):
    """Put each row's self-match in column 0 of a self-query result that does
    not pin it (host numpy; returns copies). The host search ranks by the
    expanded form |q|^2 + |x|^2 - 2 q.x clamped at 0, so where two points
    lie within f32 rounding of each other both distances are 0 and the other
    point may come first; the entries before the self-match shift right by
    one (a self-match pushed out of the k columns enters at 0)."""
    sqd, idx = np.array(sqd), np.array(idx)
    for r in np.flatnonzero(idx[:, 0] != np.arange(idx.shape[0])):
        hit = np.flatnonzero(idx[r] == r)
        j = hit[0] if hit.size else idx.shape[1] - 1
        idx[r, 1:j + 1], sqd[r, 1:j + 1] = idx[r, :j].copy(), sqd[r, :j].copy()
        idx[r, 0], sqd[r, 0] = r, 0.0
    return sqd, idx


def build_graph(x, nearest_neighbors: int, knn_backend: str = "device",
                ivf_nlist: int = None, ivf_nprobe: int = None, ivf_kmeans_iters: int = 10,
                device=None) -> SparseGraph:
    """kNN graph with the reference's construction semantics, on ``device``
    (default: the device of ``x`` when it is a tensor, else CUDA, which
    raises without a card).

    knn_backend: "device" runs the exact search on ``device``; "host" the
    exact multithreaded brute force of the native host library
    (``utils.native.knn_search_host``, its self-matches pinned to column 0
    by ``pin_self_match``); "ivf" trains an inverted-file
    quantizer on ``device`` and searches approximately. ``ivf_nlist`` /
    ``ivf_nprobe`` override the IVF sizing (default: ``default_nlist(N)``
    lists, nprobe max(16, nlist / 4))."""
    if knn_backend not in ("device", "host", "ivf"):
        raise ValueError(f"build_graph: unknown knn_backend {knn_backend!r}")
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else resolve_device("cuda")
    if knn_backend == "host":
        from ..utils.native import knn_search_host

        xh = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x)).astype(np.float32)
        sqd, idx = pin_self_match(*knn_search_host(xh, xh, nearest_neighbors))
        return symmetrize_knn_edges(sqd, idx, xh.shape[0], x=xh, device=device)
    xt = torch.as_tensor(x, dtype=torch.float32).to(device)
    if knn_backend == "ivf":
        from .knn import ivf_build, ivf_search

        index = ivf_build(xt, nlist=ivf_nlist, kmeans_iters=ivf_kmeans_iters)
        nprobe = ivf_nprobe if ivf_nprobe is not None else max(16, index.nlist // 4)
        sqd, idx = ivf_search(index, xt, nearest_neighbors, nprobe=nprobe, self_query=True)
    else:
        sqd, idx = knn_search(xt, xt, nearest_neighbors, self_query=True)
    return symmetrize_knn_edges(
        sqd.cpu().numpy(), idx.cpu().numpy(), xt.shape[0],
        x=xt.cpu().numpy(), device=device,
    )
