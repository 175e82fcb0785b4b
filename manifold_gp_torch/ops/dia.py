"""DIA (diagonal-offset) band SpMV for near-banded graphs (port of
``manifold_gp_tpu.ops.dia``), and the wrapper of kernel K4.

The RCM-reordered kNN graph of a densely sampled 1-D manifold is banded:
every edge's column offset ``perm_col - perm_row`` falls in a small set of D
distinct values. Instead of 128x128 panels this format stores one float per
(row, offset):

  band[i, d] = A[i, i + off_d]          (band: [Npd, BAND_WIDTH], D used lanes)
  (A v)[i]   = sum_d band[i, d] * v[i + off_d]

Layout contract (the JAX package's, so the tests compare the arrays):
  * true row i lives at padded index TILE + i: one leading halo tile, then
    the N rows, then a trailing pad, Npd a multiple of TILE;
  * halo and pad rows carry zero band values and zero vector entries, so the
    zero-padding subspace is invariant under the operator and whole CG/SLQ
    solves run in this space with one permute_in/permute_out pair;
  * ``offsets`` is a tuple of Python ints (sorted, includes 0);
  * the band is stored BAND_WIDTH = 128 lanes wide whatever D is (a TPU DMA
    constraint kept for equal layouts); the kernel reads only the D used
    lanes.

``dia_matvec_call`` launches the CUDA kernel K4 (``csrc/dia_spmv.cu``) for
CUDA tensors and runs ``matvec_permuted`` (one ``torch.roll`` per offset)
for CPU tensors; ``dia_launch_count`` counts the kernel's launches.
``dia_plan`` picks K4's template (row, window or general) and its row
blocking from the layout's shape and the batch. The TPU's
pad-the-batch-to-128 step does not carry over: the kernel masks a ragged
batch. ``make_matvec_ad`` is the differentiable matvec: forward K4,
``bar_pv = K4(band, g)`` (the operator is symmetric), and the band
cotangent ``bar_band``: the CUDA kernel K5 (``csrc/dia_band_grad.cu``, one
launch a call, template from ``band_grad_plan``) for CUDA tensors,
``bar_band_plain`` (one ``torch.roll``, product and row sum per offset, as
the JAX package computes it in XLA) for CPU tensors;
``dia_band_grad_launch_count`` counts K5's launches, and the traced counter
``dia.band_grad.<template>`` them while a profiler records.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import count
from . import cuda_spmv
from .graph import SparseGraph

TILE = 512  # leading halo size; Npd is a multiple of it
BAND_WIDTH = 128  # stored lanes per band row

# Launches of K4 / of K5 (the band cotangent) since the last reset (set to 0
# to reset).
dia_launch_count = 0
dia_band_grad_launch_count = 0

_BAND_MODES = {torch.float32: 0, torch.bfloat16: 1}
# K4's and K5's templates, as their C entries number them
_KINDS = {"row": 0, "general": 1, "window": 2}
# K4's block shape, as csrc/dia_spmv.cu names it: threads per block
# (kThreads), batch columns a block covers (kChunk; wider batches take
# several) and rows a thread sums in registers (kRows; the window and
# general templates).
_THREADS = 256
_CHUNK = 128
_ROWS = 8
# The most shared memory dia_plan gives a K4 block: two such blocks fit on
# an H100 SM (228 KB, 1 KB of it reserved per block). The curves' row runs
# take less (49 KB at B = 128: four blocks, whose copies and FMAs overlap).
_SMEM_BUDGET = 113 * 1024
# K5's tile, as csrc/dia_band_grad.cu names it: batch columns staged at a
# time (kChunk), rows (kRows) and band lanes (kShifts) of a tile; rows a
# row-template block takes at once (kRowWarps, one warp a row); and the row
# runs band_grad_plan aims at.
_BG_CHUNK = 128
_BG_ROWS = 4
_BG_SHIFTS = 8
_BG_ROW_WARPS = 8
_BG_RUN = 64


@dataclasses.dataclass(frozen=True)
class DiaLayout:
    """Static DIA structure of a symmetric graph Laplacian (RCM-reordered).
    Index tables are int64 for torch indexing."""

    perm: torch.Tensor  # [Npd]: permuted_v[new] = v[perm[new]] (old index)
    unperm: torch.Tensor  # [N]: out[old] = permuted_out[unperm[old]]
    edge_flat: torch.Tensor  # [2M] flat index into [Npd * BAND_WIDTH] per directed edge
    diag_flat: torch.Tensor  # [N] flat index of each node's diagonal (old order)
    offsets: Tuple[int, ...]  # D diagonal offsets (sorted, includes 0)
    num_nodes: int
    num_padded: int  # Npd (halo tile + N + trailing pad, multiple of TILE)
    halfwidth: int  # W = max |offset|

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)


def build_dia_layout(graph: SparseGraph, max_offsets: int = 24,
                     device=None) -> Optional[DiaLayout]:
    """Host-side construction: RCM ordering + diagonal-offset structure, on
    ``device`` (default: the graph's). Returns None when the reordered graph
    has more than ``max_offsets`` distinct diagonals, a halfwidth above TILE,
    or fewer than 2 * halfwidth nodes; callers then take block-ELL panels."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    device = graph.device if device is None else device
    n = graph.num_nodes
    r = graph.rows.cpu().numpy().astype(np.int64)
    c = graph.cols.cpu().numpy().astype(np.int64)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    adj = coo_matrix((np.ones(rr.shape[0], np.float32), (rr, cc)), shape=(n, n)).tocsr()
    perm_old = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64)
    inv = np.empty(n, np.int64)
    inv[perm_old] = np.arange(n)

    pr, pc = inv[rr], inv[cc]
    offs = np.unique(np.concatenate([pc - pr, np.zeros(1, np.int64)]))
    w = int(np.max(np.abs(offs)))
    if offs.size > min(max_offsets, BAND_WIDTH) or w > TILE or n < 2 * w:
        return None
    # one leading halo tile, the rows, and at least one trailing halo tile
    npd = (-(-(TILE + n) // TILE) + 1) * TILE
    edge_slots = np.searchsorted(offs, pc - pr)
    edge_flat = (TILE + pr) * BAND_WIDTH + edge_slots
    diag_flat = (TILE + inv) * BAND_WIDTH + int(np.searchsorted(offs, 0))
    # halo/pad rows gather row 0 and are zeroed by permute_in
    perm = np.zeros(npd, np.int64)
    perm[TILE:TILE + n] = perm_old

    def dev(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int64)

    return DiaLayout(
        perm=dev(perm), unperm=dev(TILE + inv), edge_flat=dev(edge_flat),
        diag_flat=dev(diag_flat), offsets=tuple(int(o) for o in offs),
        num_nodes=n, num_padded=int(npd), halfwidth=w,
    )


# Offsets of the synthetic layouts K4's general template is checked on:
# gapped within +-TILE, and (spread_offsets) BAND_WIDTH of them within +-TILE.
GAPPED_OFFSETS = (-512, -300, -7, -1, 0, 1, 7, 300, 512)


def spread_offsets(seed: int = 5) -> Tuple[int, ...]:
    """BAND_WIDTH distinct offsets within +-TILE: 0, +-TILE and the rest
    drawn with ``seed`` from within +-(TILE - 1)."""
    inner = np.setdiff1d(np.arange(1 - TILE, TILE), [0])
    drawn = np.random.default_rng(seed).choice(inner, BAND_WIDTH - 3, replace=False)
    return tuple(sorted([-TILE, 0, TILE, *drawn.tolist()]))


def layout_from_offsets(offsets, num_nodes: int, device=None) -> DiaLayout:
    """The DIA layout of an N-node operator already in band order (identity
    permutation) with these diagonal offsets, for an operator given by its
    bands rather than by a graph (it has no edge slots). Offsets are sorted
    and must include 0, with W = max |offset| <= TILE."""
    offs = tuple(sorted(int(o) for o in offsets))
    w = max(abs(o) for o in offs)
    if 0 not in offs or w > TILE or len(offs) > BAND_WIDTH or len(set(offs)) != len(offs):
        raise ValueError(f"layout_from_offsets: offsets must be distinct, include 0, at most "
                         f"{BAND_WIDTH} of them within +-{TILE}; got {offs}")
    npd = (-(-(TILE + num_nodes) // TILE) + 1) * TILE
    perm = np.zeros(npd, np.int64)
    perm[TILE:TILE + num_nodes] = np.arange(num_nodes)
    rows = TILE + np.arange(num_nodes)

    def dev(a):
        return torch.as_tensor(a).to(device=device, dtype=torch.int64)

    return DiaLayout(
        perm=dev(perm), unperm=dev(rows), edge_flat=dev(np.zeros(0, np.int64)),
        diag_flat=dev(rows * BAND_WIDTH + offs.index(0)), offsets=offs,
        num_nodes=num_nodes, num_padded=int(npd), halfwidth=w,
    )


def assemble(layout: DiaLayout, diag: torch.Tensor, triu: torch.Tensor, dtype=None):
    """Scatter the Laplacian coefficients (L = diag - A_sym) into the band
    buffer [Npd, BAND_WIDTH], in ``dtype`` (None: the coefficients' type;
    float32 or bfloat16). Edge and diagonal slots are disjoint, so one
    scatter-set places every value; scattering in the target type loses the
    same bits as casting an f32 band."""
    vals = torch.cat([-triu, -triu, diag])
    idx = torch.cat([layout.edge_flat, layout.diag_flat])
    buf_dtype = diag.dtype if dtype is None else dtype
    flat = torch.zeros(layout.num_padded * BAND_WIDTH, dtype=buf_dtype, device=diag.device)
    flat[idx] = vals.to(buf_dtype)
    return flat.reshape(layout.num_padded, BAND_WIDTH)


def permute_in(layout: DiaLayout, v: torch.Tensor) -> torch.Tensor:
    """[N, B] original order -> [Npd, B] RCM order with zeroed halo/pad rows."""
    pv = v[layout.perm]
    pv[:TILE] = 0.0
    pv[TILE + layout.num_nodes:] = 0.0
    return pv


def permute_out(layout: DiaLayout, pv: torch.Tensor) -> torch.Tensor:
    """[Npd, B] RCM order -> [N, B] original order."""
    return pv[layout.unperm]


def matvec_permuted(layout: DiaLayout, band: torch.Tensor, pv: torch.Tensor):
    """A @ pv in DIA space, one roll per diagonal: [Npd, B] -> [Npd, B]. The
    plain version of K4. Wrapped reads land only on rows whose band is zero
    (halo/pad), so they contribute nothing."""
    out = torch.zeros_like(pv)
    for j, off in enumerate(layout.offsets):
        out = out + band[:, j:j + 1].to(pv.dtype) * torch.roll(pv, -off, dims=0)
    return out


def _check(layout: DiaLayout, band: torch.Tensor, pv: torch.Tensor):
    npd = layout.num_padded
    if band.dtype not in _BAND_MODES or tuple(band.shape) != (npd, BAND_WIDTH):
        raise ValueError(f"dia_spmv: band must be float32/bfloat16 [{npd}, {BAND_WIDTH}], "
                         f"got {band.dtype} {tuple(band.shape)}")
    if pv.dtype != torch.float32 or pv.dim() != 2 or pv.shape[0] != npd:
        raise ValueError(f"dia_spmv: operand must be float32 [{npd}, B], got "
                         f"{pv.dtype} {tuple(pv.shape)}")
    if pv.shape[1] <= 0:
        raise ValueError("dia_spmv: empty batch")
    if band.device != pv.device:
        raise ValueError(f"dia_spmv: band on {band.device}, operand on {pv.device}")


class DiaPlan(NamedTuple):
    """K4's launch plan: the template, the rows a thread sums in registers
    and the rows a thread block stages."""

    template: str  # "row" (B = 1), "window" (offsets filling [-W, W]) or "general"
    rows_per_thread: int
    rows_per_block: int


def block_smem(template: str, num_offsets: int, halfwidth: int, batch: int,
               band_itemsize: int, rows_per_block: int) -> int:
    """Dynamic shared memory of one K4 block, the sum launch_window and
    launch_general in ``csrc/dia_spmv.cu`` make: the band lanes [TR, D]
    padded to 16-byte pieces, after the operand window [TR + 2W, float4
    groups of min(B, 128) columns] f32 for the window template. The row
    template stages nothing."""
    if template == "row":
        return 0
    lanes = 16 // band_itemsize
    band = rows_per_block * (-(-num_offsets // lanes) * lanes) * band_itemsize
    if template == "general":
        return band
    return (rows_per_block + 2 * halfwidth) * 16 * (-(-min(batch, _CHUNK) // 4)) + band


@functools.lru_cache(maxsize=256)
def dia_plan(offsets: Tuple[int, ...], halfwidth: int, batch: int,
             band_itemsize: int = 4) -> DiaPlan:
    """K4's template and row blocking for a layout with these ``offsets``
    and ``halfwidth`` at ``batch`` columns. B = 1 takes the row template.
    Otherwise a thread owns 8 rows of one float4 column group, and a block
    about one such row group per thread, within the shared-memory budget:
    64 rows at B = 128 and 80 at B = 100, the fastest row runs on the H100
    (PERF.md §6), small enough that four blocks share an SM. Layouts whose
    offsets are exactly -W .. W take the window template (a staged operand
    window, a sliding sum) where the window fits the budget; every other
    layout takes the general template (band staged, operand read from
    device memory)."""
    if batch <= 0:
        raise ValueError(f"dia_spmv: batch must be positive, got {batch}")
    if batch == 1:
        return DiaPlan("row", 1, _THREADS)
    want = _ROWS * max(1, _THREADS // -(-min(batch, _CHUNK) // 4))

    def most_rows(template):  # the most rows, in whole row groups, within the budget
        fixed = block_smem(template, len(offsets), halfwidth, batch, band_itemsize, 0)
        per_row = block_smem(template, len(offsets), halfwidth, batch, band_itemsize, 1) - fixed
        return max(0, _SMEM_BUDGET - fixed) // per_row // _ROWS * _ROWS

    if tuple(offsets) == tuple(range(-halfwidth, halfwidth + 1)):
        block = min(want, most_rows("window"))
        if block >= _ROWS:
            return DiaPlan("window", _ROWS, block)
    return DiaPlan("general", _ROWS, min(2 * want, most_rows("general")))


@functools.lru_cache(maxsize=256)
def _launch_args(offsets: Tuple[int, ...], halfwidth: int, batch: int, itemsize: int):
    """The C entry's layout and plan arguments, from d to rows_per_block."""
    plan = dia_plan(offsets, halfwidth, batch, itemsize)
    return ((ctypes.c_int * len(offsets))(*offsets), len(offsets), halfwidth,
            _KINDS[plan.template], plan.rows_per_thread, plan.rows_per_block)


def dia_matvec_cuda(layout: DiaLayout, band: torch.Tensor, pv: torch.Tensor):
    """Launch K4 on the current stream; raises on anything it does not take
    or on a refused launch."""
    global dia_launch_count
    _check(layout, band, pv)
    device = pv.device
    if device.type != "cuda":
        raise ValueError("dia_matvec_cuda: tensors must be on a CUDA device")
    if not (band.is_contiguous() and pv.is_contiguous()):
        raise ValueError("dia_matvec_cuda: band and operand must be contiguous")
    lib = cuda_spmv._lib or cuda_spmv._load()
    npd, batch = pv.shape
    offsets, d, w, kind, rows, block = _launch_args(layout.offsets, layout.halfwidth, batch,
                                                    band.element_size())
    out = torch.empty((npd, batch), dtype=torch.float32, device=device)
    with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = lib.dia_spmv(band.data_ptr(), pv.data_ptr(), out.data_ptr(), offsets, d, w, npd,
                           batch, BAND_WIDTH, _BAND_MODES[band.dtype], kind, rows, block,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv: launch failed with cudaError {err}")
    dia_launch_count += 1
    return out


def dia_matvec_call(layout: DiaLayout, band: torch.Tensor, pv: torch.Tensor):
    """Entry point of the JAX K4 kernel (``dia_matvec_pallas``): A @ pv in
    DIA space, pv [Npd, B] f32 (any B) with zero halo/pad rows. The CUDA
    kernel for CUDA tensors, ``matvec_permuted`` for CPU tensors."""
    if pv.device.type == "cuda":
        return dia_matvec_cuda(layout, band, pv)
    if pv.device.type == "cpu":
        _check(layout, band, pv)
        return matvec_permuted(layout, band, pv)
    raise ValueError(f"dia_spmv: unsupported device {pv.device}")


def bar_band_plain(layout: DiaLayout, g: torch.Tensor, pv: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Band cotangent bar_band[i, d] = sum_b g[i, b] * pv[i + off_d, b] in
    ``dtype`` [Npd, BAND_WIDTH], one roll per diagonal: the plain version
    of K5. The padding lanes never contribute, so their cotangent is zero;
    wrapped reads land on zero halo rows of pv."""
    out = torch.zeros((layout.num_padded, BAND_WIDTH), dtype=g.dtype, device=g.device)
    for j, off in enumerate(layout.offsets):
        out[:, j] = torch.sum(g * torch.roll(pv, -off, dims=0), dim=1)
    return out.to(dtype)


class BandGradPlan(NamedTuple):
    """K5's launch plan: the template and the rows a thread block takes."""

    template: str  # "row" (B = 1), "window" (offsets filling [-W, W]) or "general"
    rows_per_block: int


def band_grad_smem(template: str, num_offsets: int, batch: int, rows_per_block: int) -> int:
    """Dynamic shared memory of one K5 block, the sum launch_window and
    launch_general in ``csrc/dia_band_grad.cu`` make: the operand window
    [TR + 8 ceil(D / 8) - 1, float4 groups of min(B, 128) columns] f32
    (window template) before g [TR, the same groups] f32. The row template
    stages nothing."""
    if template == "row":
        return 0
    pitch = 16 * (-(-min(batch, _BG_CHUNK) // 4))
    g = rows_per_block * pitch
    if template == "general":
        return g
    return (rows_per_block + _BG_SHIFTS * -(-num_offsets // _BG_SHIFTS) - 1) * pitch + g


@functools.lru_cache(maxsize=256)
def band_grad_plan(offsets: Tuple[int, ...], halfwidth: int, batch: int) -> BandGradPlan:
    """K5's template and row run for a layout with these ``offsets`` and
    ``halfwidth`` at ``batch`` columns. B = 1 takes the row template (one
    warp a row). Otherwise a block takes 64 rows, or the most whole tiles
    of 4 rows within the shared-memory budget: layouts whose offsets are
    exactly -W .. W take the window template (a staged operand window), the
    rest the general template (g staged, operand read from device
    memory)."""
    if batch <= 0:
        raise ValueError(f"dia_band_grad: batch must be positive, got {batch}")
    if batch == 1:
        return BandGradPlan("row", _BG_ROW_WARPS)

    def most_rows(template):
        fixed = band_grad_smem(template, len(offsets), batch, 0)
        per_row = band_grad_smem(template, len(offsets), batch, 1) - fixed
        return min(_BG_RUN, max(0, _SMEM_BUDGET - fixed) // per_row // _BG_ROWS * _BG_ROWS)

    if tuple(offsets) == tuple(range(-halfwidth, halfwidth + 1)):
        rows = most_rows("window")
        if rows >= _BG_ROWS:
            return BandGradPlan("window", rows)
    return BandGradPlan("general", most_rows("general"))


@functools.lru_cache(maxsize=256)
def _band_grad_args(offsets: Tuple[int, ...], halfwidth: int, batch: int):
    """The C entry's layout and plan arguments: (offsets, d, w, kind,
    rows_per_block) and the template's name."""
    plan = band_grad_plan(offsets, halfwidth, batch)
    return (((ctypes.c_int * len(offsets))(*offsets), len(offsets), halfwidth,
             _KINDS[plan.template], plan.rows_per_block), plan.template)


def _check_band_grad(layout: DiaLayout, g: torch.Tensor, pv: torch.Tensor, dtype):
    npd = layout.num_padded
    if dtype not in _BAND_MODES:
        raise ValueError(f"dia_band_grad: band type must be float32/bfloat16, got {dtype}")
    for name, t in (("cotangent", g), ("operand", pv)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != npd:
            raise ValueError(f"dia_band_grad: {name} must be float32 [{npd}, B], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if g.shape != pv.shape:
        raise ValueError(f"dia_band_grad: cotangent {tuple(g.shape)} and operand "
                         f"{tuple(pv.shape)} differ")
    if pv.shape[1] <= 0:
        raise ValueError("dia_band_grad: empty batch")
    if g.device != pv.device:
        raise ValueError(f"dia_band_grad: cotangent on {g.device}, operand on {pv.device}")


def _launch_band_grad(layout: DiaLayout, g: torch.Tensor, pv: torch.Tensor, dtype, stream):
    """One K5 launch on ``stream`` (a CUDA stream handle) into a new [Npd,
    BAND_WIDTH] band of ``dtype`` (every lane written); counted. Arguments
    checked."""
    global dia_band_grad_launch_count
    lib = cuda_spmv._lib or cuda_spmv._load()
    npd, batch = pv.shape
    (offsets, d, w, kind, block), template = _band_grad_args(layout.offsets, layout.halfwidth,
                                                             batch)
    out = torch.empty((npd, BAND_WIDTH), dtype=dtype, device=pv.device)
    err = lib.dia_band_grad(g.data_ptr(), pv.data_ptr(), out.data_ptr(), offsets, d, w, npd,
                            batch, BAND_WIDTH, _BAND_MODES[dtype], kind, block, stream)
    if err != 0:
        raise RuntimeError(f"dia_band_grad: launch failed with cudaError {err}")
    dia_band_grad_launch_count += 1
    count(f"dia.band_grad.{template}")
    return out


def bar_band_cuda(layout: DiaLayout, g: torch.Tensor, pv: torch.Tensor, dtype) -> torch.Tensor:
    """Launch K5 on the current stream; raises on anything it does not take
    or on a refused launch."""
    _check_band_grad(layout, g, pv, dtype)
    device = pv.device
    if device.type != "cuda":
        raise ValueError("bar_band_cuda: tensors must be on a CUDA device")
    if not (g.is_contiguous() and pv.is_contiguous()):
        raise ValueError("bar_band_cuda: cotangent and operand must be contiguous")
    with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        return _launch_band_grad(layout, g, pv, dtype, torch.cuda.current_stream().cuda_stream)


def bar_band(layout: DiaLayout, g: torch.Tensor, pv: torch.Tensor, dtype) -> torch.Tensor:
    """The band cotangent bar_band[i, d] = sum_b g[i, b] * pv[i + off_d, b]
    in ``dtype`` [Npd, BAND_WIDTH], zero in the padding lanes: K5 for CUDA
    tensors, ``bar_band_plain`` for CPU tensors."""
    if pv.device.type == "cuda":
        return bar_band_cuda(layout, g, pv, dtype)
    if pv.device.type == "cpu":
        _check_band_grad(layout, g, pv, dtype)
        return bar_band_plain(layout, g, pv, dtype)
    raise ValueError(f"dia_band_grad: unsupported device {pv.device}")


class _DiaMatvec(torch.autograd.Function):
    """out = A(band) @ pv in DIA space; bar_pv = A g (both edge directions
    and the diagonal live in the band, so A is symmetric)."""

    @staticmethod
    def forward(ctx, layout, band, pv):
        pv = pv.contiguous()
        ctx.layout = layout
        ctx.save_for_backward(band, pv)
        return dia_matvec_call(layout, band, pv)

    @staticmethod
    def backward(ctx, g):
        band, pv = ctx.saved_tensors
        layout = ctx.layout
        g = g.to(pv.dtype).contiguous()
        grad_band = grad_pv = None
        if ctx.needs_input_grad[2]:
            grad_pv = dia_matvec_call(layout, band, g)
        if ctx.needs_input_grad[1]:
            grad_band = bar_band(layout, g, pv, band.dtype)
        return None, grad_band, grad_pv


def make_matvec_ad(layout: DiaLayout):
    """Differentiable DIA matvec ``mv(band, pv) -> A @ pv`` in DIA space."""

    def mv(band, pv):
        return _DiaMatvec.apply(layout, band, pv)

    return mv


def matvec(layout: DiaLayout, band: torch.Tensor, v: torch.Tensor):
    """L_sym @ v in original node order through the kernel dispatch."""
    return permute_out(layout, dia_matvec_call(layout, band, permute_in(layout, v).contiguous()))
