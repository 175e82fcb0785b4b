"""Row-sharded exact kNN search, graph build and IVF search over a process
mesh (port of ``manifold_gp_tpu.parallel.knn``).

Every rank is one process with one device (``parallel.mesh``), and every
rank receives the whole database and the whole query set, as the JAX
functions receive global arrays. Each rank searches its contiguous block of
query rows (padded to a multiple of ``world_size * block_size``), and one
``Mesh.all_gather`` of the row blocks returns the full [Nq, k] result on
every rank. Two database schedules for the exact search:

  * ``replicated`` (default): every rank searches the whole database. No
    communication but the final gather: right while the database fits one
    device (a 1M x 3 f32 database is 12 MB; the compute outgrows one
    device first).
  * ``ring``: the database is row-sharded too. ``world_size`` steps pass
    the shards round the ring with ``dist.batch_isend_irecv``
    (``parallel.spmv._ring_pass``), and every rank merges each visiting
    shard's top-k into its running top-k as ``[running k | new k]``. One
    shard per device at a time: the schedule for databases that do not fit
    replicated. Gloo has no send/recv for CUDA tensors, so on CUDA the ring
    runs over NCCL (or at world size 1); a gloo group with CUDA tensors at
    world size > 1 raises.

Each panel's top-k is the single-device search's two stages
(``ops.knn``): an approximate top-m in the expanded form |q|^2 + |x|^2 -
2 q x' on globally centered points, then the exact coordinate-differenced
re-rank of the m survivors (``_rerank_exact``). Re-ranking per panel means
the ring's merges compare exact distances. The self-match is pinned to
column 0 (``self_query``) as in ``ops.knn.knn_search``. Results equal the
single-device search up to the order of exactly tied distances.

The sharded IVF search replicates the quantizer, the posting lists and the
database, shards the query rows, and runs the single-device chunk
(``ops.knn._ivf_search_chunk``) on each rank's rows: candidates are ordered
probes-major as there, so the results equal ``ivf_search``'s on the same
index, padding slots with id -1 included (JAX's sharded IVF aliases them to
row 0).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.knn import IVFIndex, _ivf_search_chunk, _rerank_exact, refine_slack
from .mesh import Mesh
from .spmv import _ring_pass


def _pad_rows(a: torch.Tensor, multiple: int):
    """``a`` with zero rows appended up to a multiple of ``multiple``, and
    its original row count."""
    n = a.shape[0]
    pad = (-n) % multiple
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return a, n


def _block_topk(qb, q_rows, panel, panel_norm, col_base: int, n_db: int, k: int,
                self_query: bool):
    """Exact top-k of one query block against one database panel (global
    ids ``col_base`` + row; ids >= ``n_db`` are padding). The self-match
    keeps distance -1 so that the ring's merges keep it first; a panel
    with fewer than k rows is padded with +inf / -1 (the merge discards
    them)."""
    ids = col_base + torch.arange(panel.shape[0], device=panel.device)
    d = (torch.sum(qb * qb, dim=-1)[:, None] + panel_norm[None, :]) - 2.0 * (qb @ panel.T)
    d = torch.where(ids[None, :] < n_db, d, torch.full_like(d, float("inf")))
    if self_query:
        d = torch.where(ids[None, :] == q_rows[:, None], torch.full_like(d, -1.0), d)
    m = min(refine_slack(k, d.shape[1]), d.shape[1])
    neg_topm, pos = torch.topk(-d, m, dim=1)
    # the exact re-rank against the panel itself: positions, and the query
    # rows as panel positions for the self pin
    dd, pp = _rerank_exact(qb, -neg_topm, pos, panel, min(k, m), self_query=self_query,
                           q_rows=q_rows - col_base)
    ii = pp + col_base
    ii = torch.where(torch.isfinite(dd), ii, torch.full_like(ii, -1))
    if self_query:
        dd = torch.where(ii == q_rows[:, None], torch.full_like(dd, -1.0), dd)
    if dd.shape[1] < k:
        pad = k - dd.shape[1]
        dd = torch.cat([dd, dd.new_full((dd.shape[0], pad), float("inf"))], dim=1)
        ii = torch.cat([ii, ii.new_full((ii.shape[0], pad), -1)], dim=1)
    return dd, ii


def _query_blocks(mesh: Mesh, queries: torch.Tensor, block_size: int):
    """This rank's query rows of the padded query set, as (first global
    row, block) pairs of ``block_size`` rows, and the padded row count per
    rank."""
    qp, _ = _pad_rows(queries, mesh.world_size * block_size)
    per_rank = qp.shape[0] // mesh.world_size
    lo = mesh.rank * per_rank
    return [(lo + s, qp[lo + s:lo + s + block_size])
            for s in range(0, per_rank, block_size)], per_rank


def _gather_rows(mesh: Mesh, d: torch.Tensor, i: torch.Tensor, nq: int):
    """Every rank's row blocks in rank order, trimmed of the padding rows."""
    return mesh.all_gather(d)[:nq], mesh.all_gather(i)[:nq]


def _replicated_search(mesh, database, queries, k, self_query, block_size):
    n_db = database.shape[0]
    db_norm = torch.sum(database * database, dim=-1)
    dists, idxs = [], []
    blocks, _ = _query_blocks(mesh, queries, block_size)
    for row0, qb in blocks:
        rows = row0 + torch.arange(qb.shape[0], device=qb.device)
        d, i = _block_topk(qb, rows, database, db_norm, 0, n_db, k, self_query)
        dists.append(torch.clamp(d, min=0.0))
        idxs.append(i)
    return _gather_rows(mesh, torch.cat(dists), torch.cat(idxs), queries.shape[0])


def _ring_search(mesh, database, queries, k, self_query, block_size):
    ws = mesh.world_size
    if ws > 1 and database.is_cuda and dist.get_backend(mesh.group) == "gloo":
        raise RuntimeError(
            "sharded_knn_search(schedule='ring'): gloo has no send/recv for CUDA tensors; "
            "use an NCCL process group, or schedule='replicated'")
    n_db = database.shape[0]
    dbp, _ = _pad_rows(database, ws)
    chunk = dbp.shape[0] // ws
    blocks, per_rank = _query_blocks(mesh, queries, block_size)
    rows = [row0 + torch.arange(qb.shape[0], device=qb.device) for row0, qb in blocks]
    best_d = database.new_full((per_rank, k), float("inf"))
    best_i = torch.full((per_rank, k), -1, dtype=torch.int64, device=database.device)

    def step(shard, base):
        nonlocal best_d, best_i
        norm = torch.sum(shard * shard, dim=-1)
        parts = [_block_topk(qb, r, shard, norm, base, n_db, k, self_query)
                 for (_, qb), r in zip(blocks, rows)]
        cand_d = torch.cat([best_d, torch.cat([p[0] for p in parts])], dim=1)
        cand_i = torch.cat([best_i, torch.cat([p[1] for p in parts])], dim=1)
        # a stable sort keeps the earlier candidate first among ties, as
        # jax.lax.top_k does
        sd, pos = torch.sort(cand_d, dim=1, stable=True)
        best_d, best_i = sd[:, :k], torch.gather(cand_i, 1, pos[:, :k])

    _ring_pass(mesh, dbp[mesh.rank * chunk:(mesh.rank + 1) * chunk], step)
    return _gather_rows(mesh, torch.clamp(best_d, min=0.0), best_i, queries.shape[0])


def sharded_knn_search(database, queries, k: int, mesh: Mesh, self_query: bool = False,
                       block_size: int = 512, schedule: str = "replicated"):
    """Exact L2 top-k with the query rows sharded over ``mesh``.

    Same contract as ``ops.knn.knn_search`` (squared distances ascending,
    int64 ids; ``self_query`` pins the self-match to column 0), the full
    [Nq, k] result on every rank, on the mesh's device. ``schedule``:
    'replicated' keeps the database whole on every rank; 'ring'
    row-shards it and passes the shards round the ranks."""
    if schedule not in ("replicated", "ring"):
        raise ValueError(f"schedule must be 'replicated' or 'ring', got {schedule!r}")
    database = torch.as_tensor(database, dtype=torch.float32).to(mesh.device)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(mesh.device)
    if k > database.shape[0]:
        raise ValueError(f"k={k} exceeds the database size {database.shape[0]}")
    # global centering, as ops.knn.knn_search (the expanded form's
    # cancellation error scales with the centered norms)
    mu = database.mean(dim=0)
    fn = _replicated_search if schedule == "replicated" else _ring_search
    return fn(mesh, database - mu, queries - mu, int(k), bool(self_query), int(block_size))


def build_graph_sharded(x, nearest_neighbors: int, mesh: Mesh, schedule: str = "replicated",
                        block_size: int = 512):
    """Symmetric kNN graph built with the row-sharded search: the mesh form
    of ``ops.graph.build_graph`` with its edge-list semantics (search k
    including the self-match, drop the self column, orient upper
    triangular, mean-coalesce, exact edge values from ``x``), the same host
    tail on every rank; the graph on the mesh's device."""
    from ..ops.graph import symmetrize_knn_edges

    xt = torch.as_tensor(x, dtype=torch.float32).to(mesh.device)
    sqd, idx = sharded_knn_search(xt, xt, nearest_neighbors, mesh, self_query=True,
                                  block_size=block_size, schedule=schedule)
    return symmetrize_knn_edges(sqd.cpu().numpy(), idx.cpu().numpy(), xt.shape[0],
                                x=xt.cpu().numpy(), device=mesh.device)


def sharded_ivf_search(index: IVFIndex, queries, k: int, mesh: Mesh, nprobe: int = 8,
                       self_query: bool = False, block_size: int = 256,
                       queries_per_dispatch: int = 131072):
    """Approximate IVF L2 top-k with the query rows sharded over ``mesh``
    (``index`` on the mesh's device, replicated). Queries go in chunks of
    ``queries_per_dispatch`` rows, each split over the ranks; the self pin
    compares candidate ids with global query rows (the chunk's
    ``row_offset`` plus the rank's block). Returns the full (sqdist, idx)
    on every rank, equal to ``ops.knn.ivf_search``'s on the same index."""
    q = torch.as_tensor(queries, dtype=torch.float32).to(index.database.device)
    nprobe = min(nprobe, index.nlist)
    outs = []
    for s in range(0, q.shape[0], queries_per_dispatch):
        chunk = q[s:s + queries_per_dispatch]
        qp, nq = _pad_rows(chunk, mesh.world_size * block_size)
        per_rank = qp.shape[0] // mesh.world_size
        lo = mesh.rank * per_rank
        d, i = _ivf_search_chunk(index, qp[lo:lo + per_rank], k, nprobe, bool(self_query),
                                 int(block_size), s + lo)
        outs.append(_gather_rows(mesh, d, i, nq))
    if not outs:
        empty = torch.empty((0, k), device=q.device)
        return empty, empty.long()
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

