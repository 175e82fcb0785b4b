"""Row-sharded ELL SpMV (port of ``manifold_gp_tpu.parallel.spmv``).

For graphs that outgrow one device, the symmetric adjacency matvec is
sharded by contiguous row blocks: each rank owns N_pad / world_size rows of
the ELL table (padded to a divisible count) and the same rows of every
vector; the edge values (one scalar per coalesced edge) are replicated.
This is the gather-scan path with no kernel, which a mesh kernel takes when
``build_mesh_block_tables`` returns None or ``use_block_sparse=False``.

Operand exchange, per matvec:
  * gather (default): one ``all_gather`` of the [rows, B] operand, so every
    rank gathers its columns from the full vector;
  * ring (above ``_OPERAND_GATHER_BUDGET`` bytes of gathered operand): the
    ranks pass their shards round a ring with ``batch_isend_irecv`` and
    each accumulates the columns that fall in the shard it holds, so it
    never holds more than one shard. Gloo has no CUDA send/recv, so the
    ring runs on CPU tensors (gloo) and on CUDA at world size 1 (no peer to
    send to); it is checked in those two settings only.

Both are differentiable: the gather's backward is a reduce-scatter (an
all-reduce of the operand cotangent, then this rank's rows); the ring's is
a second ring pass (A_sym is symmetric, so the operand cotangent is the
same matvec of the output cotangent, and the edge cotangents contract the
output cotangent with the shards as they pass).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.graph import SparseGraph
from ..ops.operator import Operator
from .mesh import Mesh, enter_sharded

# Byte budget for the all-gathered [Np, B] operand on one device; above it
# the ring holds one [Np / world_size, B] shard at a time (the same bytes
# cross the links either way).
_OPERAND_GATHER_BUDGET = 2**28


def _local_rows(mesh: Mesh, n_pad: int):
    chunk = n_pad // mesh.world_size
    return mesh.rank * chunk, chunk


def shard_graph_rows(graph: SparseGraph, mesh: Mesh):
    """Pad the ELL table to a rank-divisible row count and keep this rank's
    rows. Returns (ell_edge, ell_col, ell_mask, n_padded): the first three
    [n_padded / world_size, D], on the mesh's device."""
    n = graph.num_nodes
    pad = (-n) % mesh.world_size
    lo, chunk = _local_rows(mesh, n + pad)

    def pad_rows(a):
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a[lo:lo + chunk].to(mesh.device)

    return (pad_rows(graph.ell_edge), pad_rows(graph.ell_col), pad_rows(graph.ell_mask),
            n + pad)


class _GatherExchange(torch.autograd.Function):
    """The full operand from every rank's rows, for a sharded consumer:
    backward sums every rank's cotangent of it and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, mesh, v):
        ctx.mesh, ctx.rows = mesh, v.shape[0]
        return mesh.all_gather(v)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return None, ctx.mesh.all_reduce(g)[lo:lo + ctx.rows]


def _ring_pass(mesh: Mesh, v_blk, step):
    """Hand this rank's shard ``v_blk`` round the ring: ``step(shard,
    base)`` sees, in turn, the shard of every rank (``base``: its first
    global row). A shard moves one rank to the left per step."""
    ndev, me, chunk = mesh.world_size, mesh.rank, v_blk.shape[0]
    shard = v_blk.contiguous()
    for s in range(ndev):
        step(shard, ((me + s) % ndev) * chunk)
        if s + 1 < ndev:
            recv = torch.empty_like(shard)
            ops = [dist.P2POp(dist.isend, shard, (me - 1) % ndev, group=mesh.group),
                   dist.P2POp(dist.irecv, recv, (me + 1) % ndev, group=mesh.group)]
            mesh._count("p2p")
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            shard = recv


class _RingMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, ell_edge, ell_col, ell_mask, triu, v):
        ev = triu[ell_edge] * ell_mask
        out = _ring_apply(mesh, ell_col, ev, v)
        ctx.mesh = mesh
        ctx.save_for_backward(ell_edge, ell_col, ell_mask, triu, v)
        return out

    @staticmethod
    def backward(ctx, g):
        ell_edge, ell_col, ell_mask, triu, v = ctx.saved_tensors
        mesh = ctx.mesh
        ev = triu[ell_edge] * ell_mask
        g = g.contiguous()
        bar_v = _ring_apply(mesh, ell_col, ev, g) if ctx.needs_input_grad[5] else None
        bar_triu = None
        if ctx.needs_input_grad[4]:
            chunk = v.shape[0]
            bar_ev = torch.zeros_like(ev)

            def step(shard, base):
                idx = ell_col - base
                inb = (idx >= 0) & (idx < chunk)
                for j in range(ell_col.shape[1]):
                    rows = shard[torch.clamp(idx[:, j], 0, chunk - 1)]
                    bar_ev[:, j] += torch.where(inb[:, j], torch.sum(g * rows, dim=1), 0.0)

            _ring_pass(mesh, v, step)
            bar_triu = torch.zeros_like(triu).index_add(
                0, ell_edge.reshape(-1), (bar_ev * ell_mask).reshape(-1))
        return None, None, None, None, bar_triu, bar_v


def _ring_apply(mesh, ell_col, ev, v):
    chunk = v.shape[0]
    acc = torch.zeros_like(v)

    def step(shard, base):
        nonlocal acc
        idx = ell_col - base
        inb = ((idx >= 0) & (idx < chunk)).to(ev.dtype)
        idxc = torch.clamp(idx, 0, chunk - 1)
        w = ev * inb
        for j in range(ell_col.shape[1]):
            acc = acc + w[:, j, None] * shard[idxc[:, j]]

    _ring_pass(mesh, v, step)
    return acc


def sharded_adjacency_matvec(ell_edge, ell_col, ell_mask, triu, v, mesh: Mesh,
                             ring: bool = None):
    """A_sym @ v over row-sharded rows.

    Args:
      ell_edge/ell_col/ell_mask: this rank's [rows / world_size, D] rows of
        the padded ELL table (``shard_graph_rows``).
      triu: [M] replicated edge values (pass them through
        ``parallel.mesh.enter_sharded`` where they need a gradient).
      v: this rank's [rows / world_size, B] rows of the operand (padding
        rows zero).
      ring: the ring schedule; None picks it when the gathered operand
        would exceed ``_OPERAND_GATHER_BUDGET`` bytes.
    Returns this rank's rows of the product.
    """
    rows = v.shape[0] * mesh.world_size
    if ring is None:
        ring = rows * v.shape[1] * v.element_size() > _OPERAND_GATHER_BUDGET
    if ring:
        return _RingMatvec.apply(mesh, ell_edge, ell_col, ell_mask, triu, v)
    v_full = _GatherExchange.apply(mesh, v) if mesh.group is not None else v
    ev = triu[ell_edge] * ell_mask
    out = torch.zeros_like(v)
    for j in range(ell_col.shape[1]):
        out = out + ev[:, j, None] * v_full[ell_col[:, j]]
    return out


def pad_nodes(a, n_padded: int, mesh: Mesh = None, fill: float = 0.0):
    """Pad an [N]-leading array to the mesh-divisible row count; with a mesh,
    keep this rank's rows, on the mesh's device."""
    a = torch.as_tensor(a)
    pad = n_padded - a.shape[0]
    if pad:
        a = torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                     device=a.device)])
    if mesh is None:
        return a
    lo, chunk = _local_rows(mesh, n_padded)
    return a[lo:lo + chunk].to(mesh.device)


def make_sharded_matern_precision_matvec(graph: SparseGraph, mesh: Mesh, coeffs, nu: int,
                                         lengthscale, normalization: str = "randomwalk",
                                         tables=None):
    """Row-sharded Matérn precision Q = D^{1/2} (2 nu/l^2 I + L_sym)^nu
    D^{1/2} (randomwalk; the symmetric normalization drops the D factors):
    each of the nu inner applications is one sharded SpMV plus a row-local
    diagonal term. Differentiable in the coefficients and the lengthscale,
    which enter the sharded computation once, through ``enter_sharded``.

    ``tables``: a ``shard_graph_rows`` result, so a kernel shards the
    static ELL structure once.

    Returns (operator, n_padded): an ``ops.operator.Operator`` on this
    rank's rows [n_padded / world_size, B] (padding rows zero, as
    ``pad_nodes`` makes them)."""
    if normalization not in ("randomwalk", "symmetric"):
        raise ValueError("normalization must be 'randomwalk' or 'symmetric', got "
                         f"{normalization!r}")
    if tables is None:
        tables = shard_graph_rows(graph, mesh)
    ell_edge, ell_col, ell_mask, n_pad = tables
    lo, chunk = _local_rows(mesh, n_pad)
    pad = n_pad - graph.num_nodes
    n, m = graph.num_nodes, coeffs.triu.shape[0]
    ls = torch.as_tensor(lengthscale, dtype=torch.float32, device=coeffs.deg.device).reshape(1)
    shared = enter_sharded(torch.cat([coeffs.diag, coeffs.triu, coeffs.deg, ls]), mesh)

    def fn(v, shared):
        diag, triu, deg, ls = torch.split(shared, [n, m, n, 1])
        shift = 2.0 * nu / torch.square(ls.reshape(()))
        diag_p = torch.nn.functional.pad(diag, (0, pad))[lo:lo + chunk] + shift
        # padding rows get degree 1 so the scalings keep them zero
        dsq_p = torch.sqrt(torch.nn.functional.pad(deg, (0, pad), value=1.0))[lo:lo + chunk]
        squeeze = v.dim() == 1
        out = v[:, None] if squeeze else v
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        for _ in range(nu):
            av = sharded_adjacency_matvec(ell_edge, ell_col, ell_mask, triu, out, mesh)
            out = diag_p[:, None] * out - av
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        return out[:, 0] if squeeze else out

    return Operator(fn, (shared,), mesh=mesh), n_pad
