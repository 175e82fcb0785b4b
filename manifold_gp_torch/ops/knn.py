"""Exact k-nearest-neighbor search (port of the exact path of
``manifold_gp_tpu.ops.knn``).

Each query chunk computes a [B, N] squared-distance block in the expanded
form |q|^2 + |x|^2 - 2 q x^T (one f32 matmul, TF32 off) and keeps its
approximate top-m with ``torch.topk``; a second stage recomputes those m
candidates' distances by coordinate differencing and re-selects the top k.
Both fixes of the JAX search come along: global centering (the expanded
form's cancellation error scales with the centered norms) and the exact
re-rank (without it, f32 expanded-form distances mis-rank neighbours at high
sampling density).

The inverted-file (IVF) search (``kmeans``, ``ivf_build``, ``ivf_search``)
runs on the tensors' device as well: Lloyd's k-means with the assignment
blocked over rows (the [N, C] distance matrix never materializes), the
posting lists packed on the host, and a search that probes each query's
``nprobe`` nearest lists and re-ranks the gathered candidates exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Distance-block budget (elements) for one query chunk: 2^28 f32 = 1 GiB.
_BLOCK_ELEMS = 2**28


def refine_slack(k: int, n: int) -> int:
    """Candidate count for the exact re-rank stage (same rule as the JAX
    search: enough candidates to cover the band of f32 expanded-form error
    around the k-th distance)."""
    return min(max(8 * k, 256), n)


def _rerank_exact(qb, cand_d, cand_i, database, k, *, self_query=False,
                  q_rows=None):
    """Exact top-k re-rank of the approximate top-m candidates.

    qb: [B, D] query chunk; cand_d/cand_i: [B, m] approximate distances
    (inf = invalid) and global ids. Returns ([B, k], [B, k]) ascending.
    A stable sort breaks ties by candidate position, as ``jax.lax.top_k``
    does."""
    pts = database[cand_i.clamp(min=0)]  # [B, m, D]
    diff = qb[:, None, :] - pts
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(torch.isfinite(cand_d), d, torch.full_like(d, float("inf")))
    if self_query:
        d = torch.where(cand_i == q_rows[:, None], torch.full_like(d, -1.0), d)
    d_sorted, pos = torch.sort(d, dim=1, stable=True)
    return d_sorted[:, :k].clamp(min=0.0), torch.gather(cand_i, 1, pos[:, :k])


def knn_search(
    database: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    self_query: bool = False,
    block_size: Optional[int] = None,
):
    """Exact L2 top-k.

    Args:
      database: [N, D] points; queries: [Nq, D] points on the same device.
      k: neighbours per query (including the self-match when self_query).
      self_query: the queries are the database itself; the self-match is
        pinned to column 0.
      block_size: query rows per chunk (default: a chunk of at most 2^28
        distance entries).

    Returns:
      (sqdist, idx): both [Nq, k]; squared L2 distances ascending, int64 ids.
    """
    database = torch.as_tensor(database, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=database.device)
    n = database.shape[0]
    nq = queries.shape[0]
    mu = database.mean(dim=0)
    database = database - mu
    queries = queries - mu
    db_norm = torch.sum(database * database, dim=-1)
    m = refine_slack(k, n)
    if block_size is None:
        block_size = max(1, min(max(nq, 1), _BLOCK_ELEMS // max(n, 1)))
    dists, idxs = [], []
    for base in range(0, nq, block_size):
        qb = queries[base:base + block_size]
        qn = torch.sum(qb * qb, dim=-1)
        d = (qn[:, None] + db_norm[None, :]) - 2.0 * (qb @ database.T)
        rows = torch.arange(base, base + qb.shape[0], device=database.device)
        if self_query:
            local = torch.arange(qb.shape[0], device=database.device)
            d[local, rows] = -1.0
        neg_topm, idx_m = torch.topk(-d, m, dim=1)
        del d
        dd, ii = _rerank_exact(
            qb, -neg_topm, idx_m, database, k, self_query=self_query, q_rows=rows
        )
        dists.append(dd)
        idxs.append(ii)
    if not dists:
        empty = torch.empty((0, k), device=database.device)
        return empty, empty.long()
    return torch.cat(dists), torch.cat(idxs)


# ---------------------------------------------------------------------------
# IVF (inverted-file) approximate search
# ---------------------------------------------------------------------------


def kmeans(x, num_clusters: int, iters: int = 10, seed: int = 0,
           block_size: int = 8192, init_idx=None):
    """Lloyd's k-means on the device of ``x``. Returns (centroids [C, D],
    assignment [N] int64).

    The initial centroids are the rows ``init_idx`` (C distinct row ids),
    else C distinct rows drawn by a CPU generator seeded with ``seed``. The
    assignment pass is blocked over rows, so the [N, C] distance matrix
    never materializes; ties go to the lowest centroid id. A centroid whose
    cluster is empty keeps its old value. The sums repeat bit for bit on
    either device (the counts are exact in f32)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n, d = x.shape
    if init_idx is None:
        init_idx = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:num_clusters]
    elif not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.asarray(init_idx, np.int64))
    cent = x[init_idx.to(device=x.device, dtype=torch.int64)]

    def assign(cent):
        cn = torch.sum(cent * cent, dim=-1)
        out = torch.empty(n, dtype=torch.int64, device=x.device)
        for s in range(0, n, block_size):
            blk = x[s:s + block_size]
            dist = (torch.sum(blk * blk, dim=-1)[:, None] - 2.0 * (blk @ cent.T)) + cn[None, :]
            out[s:s + block_size] = torch.argmin(dist, dim=-1)
        return out

    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = assign(cent)
        if x.is_cuda:
            # CUDA's index_add_ sums in atomic order; index_put_'s accumulate
            # sorts the ids and sums each cluster's rows in order
            sums = torch.zeros_like(cent).index_put_((a,), x, accumulate=True)
        else:
            sums = torch.zeros_like(cent).index_add_(0, a, x)
        cnts = torch.zeros(num_clusters, dtype=torch.float32, device=x.device).index_add_(0, a, ones)
        cent = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts, min=1.0)[:, None], cent)
    return cent, assign(cent)


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """Inverted-file index: k-means coarse quantizer and padded posting
    lists (every list padded to the longest, so a query's candidate table
    has a fixed width)."""

    centroids: torch.Tensor  # [C, D]
    lists: torch.Tensor  # [C, Lmax] int64 database row ids (0-padded)
    list_mask: torch.Tensor  # [C, Lmax] float32 validity
    database: torch.Tensor  # [N, D]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]


def default_nlist(n: int) -> int:
    """The FAISS sizing of the list count: 2^round(log2(sqrt(N)))."""
    return max(1, 2 ** int(round(np.log2(max(np.sqrt(n), 1.0)))))


def _numpy_kmeans(pts: np.ndarray, k: int, iters: int, rng: np.random.Generator):
    """Small host Lloyd's for re-splitting a cluster. Returns (cent, assign)."""
    cent = pts[rng.choice(pts.shape[0], size=k, replace=False)]
    assign = np.zeros(pts.shape[0], np.int64)
    for _ in range(iters):
        d = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                cent[j] = pts[sel].mean(0)
    return cent, assign


def _split_oversized_clusters(x_np, cent, assign, cap: int, seed: int):
    """Re-split clusters whose occupancy exceeds ``cap`` with a local k-means,
    appending the extra centroids. Bounds the padded posting-list width Lmax
    (one skewed cluster would otherwise size every query's candidate gather
    [block, nprobe * Lmax, D] by the largest cluster)."""
    rng = np.random.default_rng(seed)
    cent = np.asarray(cent, np.float32).copy()
    assign = np.asarray(assign, np.int64).copy()
    for _ in range(8):  # best-effort rounds; local k-means may not balance
        counts = np.bincount(assign, minlength=cent.shape[0])
        oversized = np.flatnonzero(counts > cap)
        if oversized.size == 0:
            break
        for c in oversized:
            idx = np.flatnonzero(assign == c)
            k_sub = min(int(-(-idx.size // cap)), idx.size)
            if k_sub < 2:
                continue
            sub_cent, sub_assign = _numpy_kmeans(x_np[idx], k_sub, 5, rng)
            base = cent.shape[0]
            cent[c] = sub_cent[0]
            cent = np.concatenate([cent, sub_cent[1:]], axis=0)
            new_ids = np.concatenate([[c], np.arange(base, base + k_sub - 1)])
            assign[idx] = new_ids[sub_assign]
    return cent, assign


def ivf_build(x, nlist: int = None, kmeans_iters: int = 10, seed: int = 0,
              max_list_factor: float = 4.0, init_idx=None) -> IVFIndex:
    """Train the coarse quantizer on the device of ``x`` and bucket the
    database (the list packing runs on the host).

    ``max_list_factor`` caps the padded list width at
    ``max_list_factor * N / nlist`` by re-splitting oversized clusters (the
    extra centroids are appended). ``init_idx``: the k-means start rows (see
    ``kmeans``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    if nlist is None:
        nlist = default_nlist(n)
    cent, assign = kmeans(x, num_clusters=nlist, iters=kmeans_iters, seed=seed,
                          init_idx=init_idx)
    cent = cent.cpu().numpy()
    assign = assign.cpu().numpy()
    cap = max(int(max_list_factor * n / max(nlist, 1)), 8)
    if np.bincount(assign, minlength=nlist).max() > cap:
        cent, assign = _split_oversized_clusters(x_np=x.cpu().numpy(), cent=cent,
                                                 assign=assign, cap=cap, seed=seed)
    nlist = cent.shape[0]
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist)
    lmax = max(int(counts.max()), 1)
    lists = np.zeros((nlist, lmax), np.int64)
    mask = np.zeros((nlist, lmax), np.float32)
    offs = np.zeros(nlist, np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    slots = np.arange(n) - offs[assign[order]]
    lists[assign[order], slots] = order
    mask[assign[order], slots] = 1.0
    return IVFIndex(
        centroids=torch.from_numpy(np.ascontiguousarray(cent, np.float32)).to(x.device),
        lists=torch.from_numpy(lists).to(x.device),
        list_mask=torch.from_numpy(mask).to(x.device),
        database=x,
    )


def ivf_search(index: IVFIndex, queries, k: int, nprobe: int = 8, self_query: bool = False,
               block_size: int = 256, queries_per_dispatch: int = 131072):
    """Approximate L2 top-k over each query's ``nprobe`` nearest posting
    lists. Returns (sqdist, idx) like ``knn_search``; ``self_query`` pins
    the self-match to column 0 (a query's own list is its nearest centroid's,
    so the self candidate is always present). Queries go in chunks of
    ``queries_per_dispatch`` rows (the chunks are independent: the self
    pinning compares candidate ids with global query row ids)."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(index.database.device)
    nprobe = min(nprobe, index.nlist)
    outs = [
        _ivf_search_chunk(index, q[s:s + queries_per_dispatch], k, nprobe, self_query,
                          block_size, s)
        for s in range(0, q.shape[0], queries_per_dispatch)
    ]
    if not outs:
        empty = torch.empty((0, k), device=q.device)
        return empty, empty.long()
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _ivf_search_chunk(index: IVFIndex, q, k: int, nprobe: int, self_query: bool,
                      block_size: int, row_offset: int):
    # Global centering (see knn_search): distances are translation-invariant
    # and centered norms minimize the expanded form's cancellation error.
    mu = index.database.mean(dim=0)
    db, cent = index.database - mu, index.centroids - mu
    q = q - mu
    cn = torch.sum(cent * cent, dim=-1)
    dists, idxs = [], []
    for base in range(0, q.shape[0], block_size):
        blk = q[base:base + block_size]
        b = blk.shape[0]
        qn = torch.sum(blk * blk, dim=-1)
        cd = (qn[:, None] + cn[None, :]) - 2.0 * (blk @ cent.T)
        probes = torch.topk(-cd, nprobe, dim=1).indices  # [B, nprobe]
        cand = index.lists[probes].reshape(b, -1)  # [B, nprobe * Lmax]
        cmask = index.list_mask[probes].reshape(b, -1)
        pts = db[cand]  # [B, cand, D]
        d = (qn[:, None] + torch.sum(pts * pts, dim=-1)) - 2.0 * torch.einsum(
            "bd,bcd->bc", blk, pts)
        d = torch.where(cmask > 0, d, torch.full_like(d, float("inf")))
        rows = row_offset + base + torch.arange(b, device=q.device)
        if self_query:
            # pin only VALID self candidates: padding slots carry id 0, which
            # would otherwise alias the self-match of query row 0
            d = torch.where((cand == rows[:, None]) & (cmask > 0), torch.full_like(d, -1.0), d)
        # stage 1: approximate top-m over the candidates; stage 2: the exact
        # coordinate-differenced re-rank
        m = min(refine_slack(k, d.shape[1]), d.shape[1])
        neg_topm, pos = torch.topk(-d, m, dim=1)
        # padding slots that reach the top m (the probed lists hold fewer than
        # m points) get id -1: as id 0 the re-rank's self pin would take them
        # for query row 0's self-match
        cand_m = torch.where(torch.isfinite(neg_topm), torch.gather(cand, 1, pos),
                             torch.full_like(pos, -1))
        dd, ii = _rerank_exact(blk, -neg_topm, cand_m, db, k, self_query=self_query,
                               q_rows=rows)
        dists.append(dd)
        idxs.append(ii)
    return torch.cat(dists), torch.cat(idxs)


class NearestNeighbors:
    """Search index over a fixed point set (the JAX class's surface:
    ``search`` and ``graph``): exact by default, or ``use_ivf=True`` for the
    inverted-file search (``nlist`` default ``default_nlist(N)``, ``nprobe``
    default max(8, nlist / 8)). ``mesh`` (a ``parallel.mesh.Mesh``): search
    with the query rows sharded over its ranks (``parallel.knn``; the points
    move to the mesh's device), composed with IVF when both are given."""

    def __init__(self, x, use_ivf: bool = False, nlist: int = None, nprobe: int = None,
                 mesh=None):
        self.x = torch.as_tensor(x, dtype=torch.float32)
        if mesh is not None:
            self.x = self.x.to(mesh.device)
        self.mesh = mesh
        self.index = None
        if use_ivf:
            self.index = ivf_build(self.x, nlist=nlist)
            self.nprobe = nprobe if nprobe is not None else max(8, self.index.nlist // 8)

    def search(self, queries, k: int, self_query: Optional[bool] = None):
        """Returns (sqdist, idx), each [Nq, k]. If the queries ARE the stored
        tensor (object identity), the self-match is pinned to column 0."""
        if self_query is None:
            self_query = queries is self.x
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.x.device)
        if self.mesh is not None:
            from ..parallel.knn import sharded_ivf_search, sharded_knn_search

            if self.index is not None:
                return sharded_ivf_search(self.index, q, k, self.mesh, nprobe=self.nprobe,
                                          self_query=self_query)
            return sharded_knn_search(self.x, q, k, self.mesh, self_query=self_query)
        if self.index is not None:
            return ivf_search(self.index, q, k, nprobe=self.nprobe, self_query=self_query)
        return knn_search(self.x, q, k, self_query)

    def graph(self, k: int):
        """Symmetric kNN graph through this index's search (sharded exact,
        sharded IVF, IVF or exact)."""
        from .graph import build_graph, symmetrize_knn_edges

        if self.mesh is not None and self.index is None:
            from ..parallel.knn import build_graph_sharded

            return build_graph_sharded(self.x, k, self.mesh)
        if self.index is not None:
            sqd, idx = self.search(self.x, k, self_query=True)
            return symmetrize_knn_edges(sqd.cpu().numpy(), idx.cpu().numpy(), self.x.shape[0],
                                        x=self.x.cpu().numpy(), device=self.x.device)
        return build_graph(self.x, k, device=self.x.device)
