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

The inverted-file (IVF) search is not ported yet.
"""

from __future__ import annotations

from typing import Optional

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


class NearestNeighbors:
    """Exact search index over a fixed point set (the JAX class's surface:
    ``search`` and ``graph``)."""

    def __init__(self, x, use_ivf: bool = False):
        if use_ivf:
            raise NotImplementedError(
                "NearestNeighbors(use_ivf=True): the IVF search is not ported "
                "yet (ROADMAP queue 1, 'Large-N ancillaries')"
            )
        self.x = torch.as_tensor(x, dtype=torch.float32)

    def search(self, queries, k: int, self_query: Optional[bool] = None):
        """Returns (sqdist, idx), each [Nq, k]. If the queries ARE the stored
        tensor (object identity), the self-match is pinned to column 0."""
        if self_query is None:
            self_query = queries is self.x
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.x.device)
        return knn_search(self.x, q, k, self_query)

    def graph(self, k: int):
        from .graph import build_graph

        return build_graph(self.x, k, device=self.x.device)
