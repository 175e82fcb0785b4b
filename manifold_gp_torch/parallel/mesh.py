"""Process mesh, sharding context and the row-sharded reductions (port of
``manifold_gp_tpu.parallel.mesh``).

The JAX mesh is single-controller GSPMD: one process, global arrays sharded
by rows, and psums that XLA inserts into every sum over the node axis. The
port runs one process per GPU on ``torch.distributed`` (NCCL on CUDA, gloo
on the CPU), and every rank holds only its own contiguous rows of a
row-sharded vector. What GSPMD inserts is spelled out here:

  * ``row_sum`` / ``row_gram`` / ``row_norm`` / ``row_max``: a reduction
    over the row axis. Under a row-role mesh context (``use_mesh``) the
    local result is all-reduced; with no mesh (or in the probe role) they
    are exactly ``torch.sum``, ``a.T @ b``, ``torch.linalg.norm`` and
    ``torch.max``, so single-device results stay bit for bit what they were. The solvers of ``ops`` call them at every
    sum over rows.
  * ``leave_sharded`` / ``enter_sharded``: the pair that keeps autograd
    right across ranks while the loss is replicated on every rank (the
    Megatron pair). A sum over local rows leaves the sharded region through
    ``leave_sharded`` (all-reduce forward, identity backward); a replicated
    tensor that enters a sharded computation passes once through
    ``enter_sharded`` (identity forward, all-reduce backward), so that its
    gradient sums the shards' partial cotangents. Every rank then holds
    complete, identical parameter gradients, and replicated terms (priors)
    count once: no gradient all-reduce after the backward is needed.
  * ``replicate``: rank 0's copy of a small replicated result.
  * ``all_gather_rows``: the full [rows, ...] tensor from every rank's
    local rows (no gradient: the served basis).

``use_mesh(mesh)`` declares that the [N]-leading tensors in its scope are
row-sharded over ``mesh`` (the context's row role). The mesh kernels and
models enter it themselves; the solvers' autograd Functions capture the
active context in their forward and re-enter it in their backward
(``use_context``).

The probe role: JAX's ``use_mesh`` also shards the probe columns of a
single-device model (``constrain_probes``, a placement hint that changes
no number). Here it is a real split. A single-device model's methods run
in ``probe_role()``, which turns an active context into the probe role:
there every sum over rows is local, and ``constrain_probes`` keeps this
rank's ``P / world_size`` columns of a probe batch, when the world size
divides ``P`` (JAX's ``_divisible`` rule; else every rank keeps all of
them). The probes are drawn or passed whole on every rank. The model then
holds its loss replicated with the same pair as the rows: its parameters
enter once through ``enter_params`` (one all-reduce of their gradient in
the backward), and each rank's share of the loss (its own probes'
estimate, the replicated terms divided by the world size) leaves through
``leave_sharded``. Only scalars and parameter-sized tensors are reduced.
``constrain_nodes`` keeps its name and returns the tensor unchanged.

Collectives: ``Mesh.all_reduce``, ``Mesh.all_gather`` and
``Mesh.broadcast`` on the mesh's group; ``collective_counts`` counts the
calls (by name) since it was last cleared. Both backends run these three
on CUDA tensors (gloo too, in PyTorch 2.11 built for CUDA 12.8:
chip_smoke.py phase 14a runs them with two processes on one card), so no
call is staged through host memory. The operand exchanges use no
send/recv, which gloo lacks for CUDA tensors (only the ring schedules of
``parallel.spmv`` and ``parallel.knn`` do: on CPU tensors over gloo, on CUDA
over NCCL).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device

# Collective calls since the last clear(), by name.
collective_counts: dict = {}


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 60.0) -> int:
    """Join the process group (once per process, before ``make_mesh``):
    NCCL when CUDA is available, else gloo, unless ``backend`` says which.
    ``init_method`` defaults to ``env://`` (what ``torchrun`` sets up); a
    process started without ``WORLD_SIZE`` in its environment and without
    ``world_size`` joins no group. No-op when already initialised. Returns
    the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_world_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ``world_size`` processes, one device each: this
    process's ``rank`` and ``device`` and the process ``group`` (None: one
    process and no group, where every collective is the identity)."""

    group: object
    rank: int
    world_size: int
    device: torch.device

    def _count(self, name):
        collective_counts[name] = collective_counts.get(name, 0) + 1

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of every rank's ``t``, in a new tensor."""
        if self.group is None:
            return t
        self._count("all_reduce")
        out = t.detach().contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in a new tensor."""
        if self.group is None:
            return t
        self._count("broadcast")
        out = t.detach().contiguous().clone()
        dist.broadcast(out, src=src, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along dim 0 in
        rank order."""
        if self.group is None:
            return t
        self._count("all_gather")
        src = t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0)


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D mesh over the initialised process group (one process per
    device; ``num_devices``, when given, must equal the world size), or a
    one-process mesh with no group. On CUDA each process takes the card
    ``LOCAL_RANK`` (else its rank) modulo the visible cards."""
    if dist.is_initialized():
        group, rank, ws = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, ws = None, 0, 1
    if num_devices is not None and int(num_devices) != ws:
        raise ValueError(f"make_mesh: {num_devices} devices asked for, but the process "
                         f"group has {ws} processes (one per device)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=rank, world_size=ws, device=dev)


NODE_AXIS = "nodes"
PROBE_AXIS = "probes"


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    """An active mesh and the axis it shards: ``NODE_AXIS`` (the rows of
    a mesh kernel's vectors) or ``PROBE_AXIS`` (the probe columns of a
    single-device model)."""

    mesh: Mesh
    axis: str = NODE_AXIS


_ACTIVE: list = []


def active_context() -> Optional[ShardingContext]:
    return _ACTIVE[-1] if _ACTIVE else None


def active_mesh() -> Optional[Mesh]:
    """The mesh the rows in scope are sharded over (None outside a
    row-role context)."""
    ctx = active_context()
    return None if ctx is None or ctx.axis != NODE_AXIS else ctx.mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Row-shard the reductions of every solver call in scope over ``mesh``
    (a no-op scope for None). A single-device model takes a user's scope in
    the probe role (``probe_role``)."""
    if mesh is None:
        yield None
        return
    with use_context(ShardingContext(mesh)) as ctx:
        yield ctx


@contextlib.contextmanager
def use_context(ctx: Optional[ShardingContext]):
    """Re-enter a captured ``active_context()``: a Function's backward runs
    in its forward's context, whatever is active where the backward is
    called (None: no context, masking an active one)."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def probe_role():
    """The scope of a single-device model's computation: an active
    context's mesh in the probe role (a no-op scope without one)."""
    ctx = active_context()
    if ctx is None or ctx.axis == PROBE_AXIS:
        yield
        return
    with use_context(ShardingContext(ctx.mesh, PROBE_AXIS)):
        yield


def in_probe_role(method):
    """Run a model's (or kernel's) method in ``probe_role`` unless the
    object is a mesh one (``self.mesh``), whose own scopes shard rows."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        if getattr(self, "mesh", None) is not None:
            return method(self, *args, **kwargs)
        with probe_role():
            return method(self, *args, **kwargs)

    return wrapped


def probe_split(num_columns: int) -> Optional[Mesh]:
    """The mesh a batch of ``num_columns`` probe columns is split over: the
    active probe-role context's, when it has more than one rank and its
    world size divides ``num_columns``; else None (no split)."""
    ctx = active_context()
    if ctx is None or ctx.axis != PROBE_AXIS:
        return None
    ws = ctx.mesh.world_size
    return ctx.mesh if ws > 1 and num_columns % ws == 0 else None


def constrain_nodes(x):
    """JAX's placement hint for the node axis: changes no number; here the
    tensor unchanged."""
    return x


def constrain_probes(x):
    """This rank's columns of a probe batch ``x`` [N, P] under a probe
    split (``probe_split``), else ``x`` itself."""
    mesh = probe_split(x.shape[1]) if x.dim() >= 2 else None
    if mesh is None:
        return x
    w = x.shape[1] // mesh.world_size
    return x[:, mesh.rank * w:(mesh.rank + 1) * w].contiguous()


# -- the Megatron pair -------------------------------------------------------


class _LeaveSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_reduce(g)


def leave_sharded(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum over ranks of a local partial ``t`` (all-reduce forward,
    identity backward); ``t`` itself with no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    return t if mesh is None or mesh.group is None else _LeaveSharded.apply(mesh, t)


def enter_sharded(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """A replicated ``t`` entering a sharded computation (identity forward,
    all-reduce backward); ``t`` itself with no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None or mesh.group is None:
        return t
    return _EnterSharded.apply(mesh, t)


def enter_params(params: dict, mesh: Mesh) -> dict:
    """A dict of replicated tensors entering a sharded computation in one
    piece: ``enter_sharded`` of their concatenation, so the backward
    all-reduces one parameter-sized vector."""
    names = list(params)
    flat = enter_sharded(torch.cat([params[k].reshape(-1) for k in names]), mesh)
    parts = torch.split(flat, [params[k].numel() for k in names])
    return {k: part.view(params[k].shape) for k, part in zip(names, parts)}


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The full row-sharded tensor from every rank's local rows ``t`` (no
    gradient); ``t`` itself with no mesh."""
    mesh = active_mesh() if mesh is None else mesh
    return t if mesh is None else mesh.all_gather(t)


# -- reductions over the row axis ----------------------------------------------


def row_sum(t: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """``torch.sum`` over the (row-sharded) ``dim``."""
    return leave_sharded(torch.sum(t, dim=dim, keepdim=keepdim))


def row_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.T @ b`` for row-sharded ``a`` and ``b``."""
    return leave_sharded(a.T @ b)


def row_norm(x: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """``torch.linalg.norm`` over the row-sharded ``dim``."""
    if active_mesh() is None:
        return torch.linalg.norm(x, dim=dim, keepdim=keepdim)
    return torch.sqrt(row_sum(x * x, dim=dim, keepdim=keepdim))


def row_max(t: torch.Tensor) -> torch.Tensor:
    """``torch.max`` of a row-sharded tensor (no gradient)."""
    mesh = active_mesh()
    m = torch.max(t)
    return m if mesh is None else mesh.all_reduce(m, op=dist.ReduceOp.MAX)


def replicate(*ts: torch.Tensor):
    """Rank 0's copies of replicated results (small ``eigh`` / ``qr`` /
    ``svd`` outputs, or rows only rank 0 holds), in one broadcast, so that
    every rank takes the same values even where two devices' libraries
    round differently; the tensors themselves with no mesh or one rank. One
    tensor in, one out."""
    mesh = active_mesh()
    if mesh is not None and mesh.world_size > 1:
        flat = mesh.broadcast(torch.cat([t.reshape(-1) for t in ts]), src=0)
        ts = [part.reshape(t.shape) for part, t in
              zip(torch.split(flat, [t.numel() for t in ts]), ts)]
    return ts[0] if len(ts) == 1 else tuple(ts)
