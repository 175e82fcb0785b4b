"""Exact kNN graph in float64: each point's k - 1 nearest other points,
every pair once (row < col), squared lengths by coordinate differences."""

from __future__ import annotations

import numpy as np
import torch


def knn(database: torch.Tensor, queries: torch.Tensor, k: int, exclude_self: bool,
        block: int = 1024):
    """(sqdist [nq, k], idx [nq, k]) of the k nearest database points of each
    query, ascending, in float64; ``exclude_self`` drops query i == point i
    (the queries are the database)."""
    mu = database.mean(dim=0)
    db = database - mu
    q_all = queries - mu
    db_norm = torch.sum(db * db, dim=1)
    out_d, out_i = [], []
    for base in range(0, q_all.shape[0], block):
        q = q_all[base:base + block]
        d = torch.sum(q * q, dim=1)[:, None] + db_norm[None, :] - 2.0 * (q @ db.T)
        if exclude_self:
            rows = torch.arange(q.shape[0], device=q.device)
            d[rows, rows + base] = float("inf")
        # candidates by the expanded form, then exact differences among them
        cand = torch.topk(d, min(k + 8, d.shape[1]), dim=1, largest=False).indices
        diff = db[cand] - q[:, None, :]
        exact = torch.sum(diff * diff, dim=2)
        dd, order = torch.sort(exact, dim=1, stable=True)
        out_d.append(dd[:, :k])
        out_i.append(torch.gather(cand, 1, order[:, :k]))
    return torch.cat(out_d), torch.cat(out_i)


def knn_graph(x: np.ndarray, k: int, device) -> tuple:
    """The symmetric kNN graph of ``x`` ([n, dim]): each point joined to its
    k - 1 nearest other points (``k`` counts the point itself), as the
    unique pairs (rows, cols) with rows < cols, int64 tensors, and their
    squared lengths in float64."""
    xd = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
    n = xd.shape[0]
    _, idx = knn(xd, xd, k - 1, exclude_self=True)
    src = torch.arange(n, device=device).repeat_interleave(k - 1)
    dst = idx[:, : k - 1].reshape(-1)
    key = torch.unique(torch.minimum(src, dst) * n + torch.maximum(src, dst))
    rows, cols = key // n, key % n
    diff = xd[rows] - xd[cols]
    return rows, cols, torch.sum(diff * diff, dim=1)


def edge_mismatch(rows_a, cols_a, rows_b, cols_b, n: int) -> int:
    """Pairs in one edge set and not the other (row < col in both)."""
    a = np.unique(np.asarray(rows_a, np.int64) * n + np.asarray(cols_a, np.int64))
    b = np.unique(np.asarray(rows_b, np.int64) * n + np.asarray(cols_b, np.int64))
    return int(np.setxor1d(a, b, assume_unique=True).size)
