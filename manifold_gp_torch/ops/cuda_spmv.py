"""Block-ELL Laplacian SpMV on Hopper: the CUDA kernels that replace the
Pallas kernels K1/K2 (forward) and K3 (panel cotangent) of
``manifold_gp_tpu.ops.pallas_spmv``, the autograd Functions around them, and
the build of the port's one kernel library.

The kernels (``csrc/block_ell_spmv.cu``, ``csrc/block_ell_bwd_blocks.cu``,
and ``csrc/dia_spmv.cu``, kernel K4, wrapped by ``ops.dia``) are CUDA C++
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` (one
``nvcc -c`` per source, started together, then one link) into one shared
library with a plain C interface and loaded with ``ctypes``, at first use,
into ``manifold_gp_torch/build/`` (named by a hash of every file of
``csrc/``, the ``.cuh`` headers the sources include among them, so an edit
to any of them rebuilds). Nothing is built or loaded when this module is
imported.

Dispatch: for CUDA tensors the wrappers launch the kernel or raise; for CPU
tensors they run ``block_matvec_plain`` / ``bwd_blocks_plain``, the same
arithmetic in PyTorch (gather, then a batched product, with the bf16
roundings and the x3 products spelled out). There is no fallback from a
CUDA tensor to a plain version.

On the TPU, K1 (operand resident in VMEM) and K2 (operand streamed from HBM)
differ only in where the operand lives; on a GPU it always lives in device
memory with L2 as its cache, so K1 and K2 merge into one kernel:
``resident_matvec_call`` and ``stream_matvec_call`` are two names for one
entry point, and ``_run_block_kernel`` has no size switch. Neither the
8 MiB VMEM budget nor the pad-to-128 batch requirement carries over: the
kernel takes a batch tile sized to B (``_batch_tile``) and masks a ragged
batch edge itself.

``make_matvec_ad`` and ``make_matvec_edge_ad`` are the differentiable
matvecs of training (``torch.autograd.Function``s): the cotangent of the
operand is the forward kernel applied to ``g`` (the operator is symmetric),
the cotangent of the panels is K3. On the GPU there is no "resident einsum
below a size budget" branch: the device alone picks kernel or plain version.

``window_matvec_call`` / ``window_bwd_blocks_call`` run the same two
kernels on one shard of a row-sharded layout (``parallel.block_spmv``):
local panels against an exchanged window operand, with block ids relative
to the window, checked once when the shard's tables were built.

``launch_count`` counts launches of the forward kernel (and
``launch_count_by_batch`` them by batch width) and ``bwd_launch_count``
those of K3 (and ``bwd_launch_count_by_batch``), each incremented only
where its kernel is launched, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from ..utils.metrics import span
from .block_sparse import BLOCK, BlockLayout, check_block_cols, permute_in, permute_out

# Launches of the forward kernel / of K3 since the last reset (set to 0 to
# reset); also by batch width (clear() to reset).
launch_count = 0
bwd_launch_count = 0
launch_count_by_batch: dict = {}
bwd_launch_count_by_batch: dict = {}

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = (_CSRC / "block_ell_spmv.cu", _CSRC / "block_ell_bwd_blocks.cu",
            _CSRC / "dia_spmv.cu")
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
_BATCH_TILES = (8, 16, 32, 64, 128)  # the forward kernel's batch-tile templates
_BWD_CHUNK = 32  # K3: batch columns per chunk above its widest resident class
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_OUT_MODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_X3 = 2

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("block_ell kernels: nvcc not found (needed to build the CUDA kernels)")


def _hashed_sources() -> list[pathlib.Path]:
    """Every file the library is built from: the ``.cu`` sources it
    compiles and the ``.cuh`` headers they include, sorted by name."""
    return sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def _library_digest() -> str:
    """Hash of the compiler flags and of every file of ``csrc/``: the name
    of the library built from them."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _hashed_sources():
        h.update(src.name.encode() + src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> pathlib.Path:
    """Compile the kernel sources into one library in the package's build
    directory (once per content of every file of ``csrc/``) and return its
    path. The ``.cu`` sources compile side by side, one ``nvcc -c`` each,
    then link."""
    global build_log
    digest = _library_digest()
    lib_path = _BUILD_DIR / f"libblock_ell-{digest}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    objects = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in _SOURCES]
    tmp = _BUILD_DIR / f"libblock_ell.{tag}.tmp"
    try:
        procs = [
            subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_SOURCES, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"block_ell kernels: nvcc failed:\n{build_log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"block_ell kernels: link failed:\n{build_log}")
        os.replace(tmp, lib_path)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return lib_path


def _load():
    """The kernel library, built and loaded at first use (the set-up span
    ``imgp.ext.load``)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            with span("imgp.ext.load", total=True):
                lib = ctypes.CDLL(str(build_library()))
            fn = lib.block_ell_spmv
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            bwd = lib.block_ell_bwd_blocks
            bwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            bwd.restype = ctypes.c_int
            dia = lib.dia_spmv  # K4, wrapped by ops.dia
            dia.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
            dia.restype = ctypes.c_int
            _lib = lib
    return _lib


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """f32 -> stacked [2, ...] bf16 (hi, lo) with x ~ hi + lo to ~2^-16."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo], dim=0)


def merge_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """Stacked [2, ...] bf16 (hi, lo) -> f32 reconstruction."""
    return x[0].to(torch.float32) + x[1].to(torch.float32)


def _is_x3(blocks) -> bool:
    return blocks.dim() == 4 and blocks.shape[0] == 2


def _check(bc_flat, blocks, pv, s_max):
    """Validate what the kernel takes; returns (nrb, batch, mode)."""
    x3 = _is_x3(blocks)
    if x3 and blocks.dtype != torch.bfloat16:
        raise TypeError("block_ell_spmv: x3 panels must be bfloat16 [2, nrb, 128, S*128]")
    if not x3 and (blocks.dim() != 3 or blocks.dtype not in _MODES):
        raise TypeError(
            "block_ell_spmv: panels must be float32/bfloat16 [nrb, 128, S*128] "
            f"or bfloat16 [2, nrb, 128, S*128]; got {blocks.dtype} {tuple(blocks.shape)}"
        )
    nrb = blocks.shape[1] if x3 else blocks.shape[0]
    if tuple(blocks.shape[-2:]) != (BLOCK, s_max * BLOCK):
        raise ValueError(f"block_ell_spmv: panel shape {tuple(blocks.shape)} != [.., 128, {s_max}*128]")
    if bc_flat.dtype != torch.int32 or bc_flat.dim() != 1 or bc_flat.numel() != nrb * s_max:
        raise ValueError("block_ell_spmv: block_col must be int32 [nrb*S]")
    if pv.dtype != torch.float32 or pv.dim() != 2 or pv.shape[0] % BLOCK:
        raise ValueError("block_ell_spmv: operand must be float32 [rows, B] with rows % 128 == 0")
    if min(nrb, s_max, pv.shape[0], pv.shape[1]) <= 0:
        raise ValueError(f"block_ell_spmv: empty problem (nrb={nrb}, S={s_max}, "
                         f"operand {tuple(pv.shape)})")
    devices = {bc_flat.device, blocks.device, pv.device}
    if len(devices) != 1:
        raise ValueError(f"block_ell_spmv: tensors on different devices: {devices}")
    return nrb, pv.shape[1], (_MODE_X3 if x3 else _MODES[blocks.dtype])


def _batch_tile(batch: int) -> int:
    """The forward kernel's batch tile for a batch of ``batch`` columns: the
    smallest template width >= min(batch, 128). Wider batches take several
    128-wide tiles."""
    if batch <= 0:
        raise ValueError(f"block_ell_spmv: batch must be positive, got {batch}")
    return next(tb for tb in _BATCH_TILES if tb >= min(batch, _BATCH_TILES[-1]))


def block_matvec_plain(bc_flat, blocks, pv, *, s_max: int):
    """The kernel's arithmetic in plain PyTorch, on any device. Returns
    [nrb*128, B] f32."""
    nrb, batch, mode = _check(bc_flat, blocks, pv, s_max)
    grouped = pv.reshape(-1, BLOCK, batch)
    cb = grouped.index_select(0, bc_flat).reshape(nrb, s_max * BLOCK, batch)
    if mode == _MODE_X3:
        sh = cb.to(torch.bfloat16)
        sl = (cb - sh.to(torch.float32)).to(torch.bfloat16).to(torch.float32)
        sh = sh.to(torch.float32)
        hi = blocks[0].to(torch.float32)
        lo = blocks[1].to(torch.float32)
        out = torch.bmm(hi, sh) + torch.bmm(hi, sl) + torch.bmm(lo, sh)
    elif mode == _MODES[torch.bfloat16]:
        out = torch.bmm(blocks.to(torch.float32), cb.to(torch.bfloat16).to(torch.float32))
    else:
        out = torch.bmm(blocks, cb)
    return out.reshape(nrb * BLOCK, batch)


def block_matvec_cuda(bc_flat, blocks, pv, *, s_max: int):
    """Launch the CUDA kernel on the current stream. All tensors on one CUDA
    device and contiguous; raises on anything else or on a refused launch.
    The caller vouches that every ``bc_flat`` id indexes a 128-row slice of
    ``pv`` (``check_block_cols``)."""
    global launch_count
    nrb, batch, mode = _check(bc_flat, blocks, pv, s_max)
    if pv.device.type != "cuda":
        raise ValueError("block_matvec_cuda: tensors must be on a CUDA device")
    for name, t in (("block_col", bc_flat), ("panels", blocks), ("operand", pv)):
        if not t.is_contiguous():
            raise ValueError(f"block_matvec_cuda: {name} must be contiguous")
    lib = _load()
    out = torch.empty((nrb * BLOCK, batch), dtype=torch.float32, device=pv.device)
    with torch.cuda.device(pv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_ell_spmv(
            blocks.data_ptr(), bc_flat.data_ptr(), pv.data_ptr(), out.data_ptr(),
            nrb, s_max, batch, mode, _batch_tile(batch), stream,
        )
    if err != 0:
        raise RuntimeError(f"block_ell_spmv: launch failed with cudaError {err}")
    launch_count += 1
    launch_count_by_batch[batch] = launch_count_by_batch.get(batch, 0) + 1
    return out


def _dispatch(bc_flat, blocks, pv, s_max):
    if pv.device.type == "cuda":
        return block_matvec_cuda(bc_flat, blocks, pv, s_max=s_max)
    if pv.device.type == "cpu":
        return block_matvec_plain(bc_flat, blocks, pv, s_max=s_max)
    raise ValueError(f"block_ell_spmv: unsupported device {pv.device}")


def resident_matvec_call(bc_flat, blocks, pv, *, s_max: int):
    """Entry point of the JAX K1 and K2 kernels, which merge into one on the
    GPU: panels ``blocks`` ([nrb, 128, S*128] or x3 [2, nrb, 128, S*128])
    with ``bc_flat`` [nrb*S] int32 may cover a slice of the rows while
    ``pv`` ([rows, B], any B) is the full operand their column ids index;
    the ids are checked against it. Returns [nrb*128, B]."""
    check_block_cols(bc_flat, pv.shape[0] // BLOCK)
    return _dispatch(bc_flat, blocks, pv, s_max)


stream_matvec_call = resident_matvec_call


def _check_window(name, window, num_col_blocks):
    if window.dim() != 2 or window.shape[0] != num_col_blocks * BLOCK:
        raise ValueError(f"{name}: the window operand has {tuple(window.shape)} rows, its "
                         f"block ids were checked against {num_col_blocks} column blocks")


def window_matvec_call(bc_flat, blocks, window, *, s_max: int, num_col_blocks: int):
    """The forward kernel on one shard of a row-sharded layout
    (``parallel.block_spmv``): local panels [lrb, 128, S*128] against the
    exchanged ``window`` operand [num_col_blocks*128, B], whose rows are not
    the global row space; ``bc_flat`` [lrb*S] holds block ids relative to
    the window, checked against ``num_col_blocks`` once when the shard's
    tables were built (no per-call device sync). Raises on a window of any
    other height. Returns [lrb*128, B]."""
    _check_window("window_matvec_call", window, num_col_blocks)
    return _dispatch(bc_flat, blocks, window, s_max)


def window_bwd_blocks_call(bc_flat, g, window, *, s_max: int, num_col_blocks: int,
                           out_dtype=torch.float32):
    """K3 on one shard: the local panel cotangent ``g`` [lrb*128, B] times
    the exchanged ``window``, with window-relative block ids checked once
    (``window_matvec_call``). Returns [lrb, 128, S*128] in ``out_dtype``."""
    _check_window("window_bwd_blocks_call", window, num_col_blocks)
    return _dispatch_bwd(bc_flat, g, window, s_max, out_dtype)


def block_matvec(layout: BlockLayout, blocks, pv):
    """L_sym @ pv in permuted space. pv: [Np, B] with zeroed padding rows."""
    return _run_block_kernel(layout, blocks, pv)


def _run_block_kernel(layout: BlockLayout, blocks, pv):
    # The layout's ids were checked against its row blocks when it was built
    # (BlockLayout.__post_init__), so an operand of the layout's height needs
    # no per-apply check.
    if pv.shape[0] != layout.num_padded:
        raise ValueError(f"block_matvec: operand has {pv.shape[0]} rows, the layout "
                         f"{layout.num_padded}")
    return _dispatch(layout.block_col.reshape(-1), blocks, pv, layout.max_blocks)


def matvec(layout: BlockLayout, blocks, v):
    """L_sym @ v in original node order through the kernel dispatch."""
    return permute_out(layout, block_matvec(layout, blocks, permute_in(layout, v)))


# ---------------------------------------------------------------------------
# K3: the panel cotangent  bar_blocks[r] = g[r] @ gathered_pv[r]^T
# ---------------------------------------------------------------------------


def _check_bwd(bc_flat, g, pv, s_max, out_dtype):
    """Validate what K3 takes; returns (nrb, batch)."""
    if out_dtype not in _OUT_MODES:
        raise TypeError(f"block_ell_bwd_blocks: out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("g", g), ("operand", pv)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] % BLOCK:
            raise ValueError(f"block_ell_bwd_blocks: {name} must be float32 [rows, B] "
                             f"with rows % 128 == 0; got {t.dtype} {tuple(t.shape)}")
    if g.shape[1] != pv.shape[1]:
        raise ValueError(f"block_ell_bwd_blocks: g has batch {g.shape[1]}, the operand {pv.shape[1]}")
    nrb = g.shape[0] // BLOCK
    if bc_flat.dtype != torch.int32 or bc_flat.dim() != 1 or bc_flat.numel() != nrb * s_max:
        raise ValueError("block_ell_bwd_blocks: block_col must be int32 [nrb*S]")
    if min(nrb, s_max, pv.shape[0], pv.shape[1]) <= 0:
        raise ValueError(f"block_ell_bwd_blocks: empty problem (nrb={nrb}, S={s_max}, "
                         f"operand {tuple(pv.shape)})")
    devices = {bc_flat.device, g.device, pv.device}
    if len(devices) != 1:
        raise ValueError(f"block_ell_bwd_blocks: tensors on different devices: {devices}")
    return nrb, pv.shape[1]


def _bwd_batch_class(batch: int) -> int:
    """K3's batch class for a batch of ``batch`` columns: the columns of
    shared memory a factor tile holds, 16, 32 or 64 (the smallest that
    holds the batch, g then staged once per row block); above 64, 32 (the
    batch runs in 32-column chunks)."""
    if batch <= 0:
        raise ValueError(f"block_ell_bwd_blocks: batch must be positive, got {batch}")
    return next((kb for kb in (16, 32, 64) if batch <= kb), _BWD_CHUNK)


def bwd_blocks_plain(bc_flat, g, pv, *, s_max: int, out_dtype=torch.float32):
    """K3's arithmetic in plain PyTorch, on any device: gather the operand
    slices, then one batched product over the batch dimension. For bf16
    output both factors are rounded to bf16 first (their products are exact
    in f32), accumulated in f32 and rounded once. Returns
    [nrb, 128, S*128]."""
    nrb, batch = _check_bwd(bc_flat, g, pv, s_max, out_dtype)
    cb = pv.reshape(-1, BLOCK, batch).index_select(0, bc_flat).reshape(nrb, s_max * BLOCK, batch)
    g3 = g.reshape(nrb, BLOCK, batch)
    if out_dtype == torch.bfloat16:
        g3 = g3.to(torch.bfloat16).to(torch.float32)
        cb = cb.to(torch.bfloat16).to(torch.float32)
    return torch.bmm(g3, cb.transpose(1, 2)).to(out_dtype)


def bwd_blocks_cuda(bc_flat, g, pv, *, s_max: int, out_dtype=torch.float32):
    """Launch K3 on the current stream. All tensors on one CUDA device and
    contiguous; raises on anything else or on a refused launch. The caller
    vouches that every ``bc_flat`` id indexes a 128-row slice of ``pv``."""
    global bwd_launch_count
    nrb, batch = _check_bwd(bc_flat, g, pv, s_max, out_dtype)
    if pv.device.type != "cuda":
        raise ValueError("bwd_blocks_cuda: tensors must be on a CUDA device")
    for name, t in (("block_col", bc_flat), ("g", g), ("operand", pv)):
        if not t.is_contiguous():
            raise ValueError(f"bwd_blocks_cuda: {name} must be contiguous")
    lib = _load()
    out = torch.empty((nrb, BLOCK, s_max * BLOCK), dtype=out_dtype, device=pv.device)
    with torch.cuda.device(pv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_ell_bwd_blocks(
            g.data_ptr(), bc_flat.data_ptr(), pv.data_ptr(), out.data_ptr(),
            nrb, s_max, batch, _OUT_MODES[out_dtype], _bwd_batch_class(batch), stream,
        )
    if err != 0:
        raise RuntimeError(f"block_ell_bwd_blocks: launch failed with cudaError {err}")
    bwd_launch_count += 1
    bwd_launch_count_by_batch[batch] = bwd_launch_count_by_batch.get(batch, 0) + 1
    return out


def _dispatch_bwd(bc_flat, g, pv, s_max, out_dtype):
    if pv.device.type == "cuda":
        return bwd_blocks_cuda(bc_flat, g, pv, s_max=s_max, out_dtype=out_dtype)
    if pv.device.type == "cpu":
        return bwd_blocks_plain(bc_flat, g, pv, s_max=s_max, out_dtype=out_dtype)
    raise ValueError(f"block_ell_bwd_blocks: unsupported device {pv.device}")


def bwd_blocks_call(bc_flat, g, pv, *, s_max: int, out_dtype=torch.float32):
    """Entry point of the JAX K3 kernel with explicit dims: ``g``
    ([nrb*128, B]) covers the panel rows, ``pv`` ([rows, B], any B) is the
    full operand the column ids index; the ids are checked against it.
    Returns [nrb, 128, S*128] in ``out_dtype``."""
    check_block_cols(bc_flat, pv.shape[0] // BLOCK)
    return _dispatch_bwd(bc_flat, g, pv, s_max, out_dtype)


def block_bwd_blocks(layout: BlockLayout, g, pv, out_dtype=torch.float32):
    """Panel cotangent bar_blocks [nrb, 128, S*128] from cotangent g and
    operand pv (both [Np, B] in permuted space). The layout's ids were
    checked when it was built."""
    if pv.shape[0] != layout.num_padded or g.shape[0] != layout.num_padded:
        raise ValueError(f"block_bwd_blocks: g/operand have {g.shape[0]}/{pv.shape[0]} rows, "
                         f"the layout {layout.num_padded}")
    return _dispatch_bwd(layout.block_col.reshape(-1), g, pv, layout.max_blocks, out_dtype)


# ---------------------------------------------------------------------------
# Differentiable matvecs
# ---------------------------------------------------------------------------


class _BlockMatvec(torch.autograd.Function):
    """out = M(blocks) @ pv in permuted space. bar_pv = M g (``assemble``
    scatters both edge directions plus the diagonal, so M is symmetric);
    bar_blocks is K3 in the panels' type (x3 panels: the output is linear
    in hi + lo, so both halves receive the same bf16 cotangent)."""

    @staticmethod
    def forward(ctx, layout, blocks, pv):
        pv = pv.contiguous()
        ctx.layout = layout
        ctx.save_for_backward(blocks, pv)
        return _run_block_kernel(layout, blocks, pv)

    @staticmethod
    def backward(ctx, g):
        blocks, pv = ctx.saved_tensors
        layout = ctx.layout
        g = g.to(pv.dtype).contiguous()
        bar_blocks = bar_pv = None
        if ctx.needs_input_grad[2]:
            bar_pv = _run_block_kernel(layout, blocks, g)
        if ctx.needs_input_grad[1]:
            x3 = _is_x3(blocks)
            bar_blocks = block_bwd_blocks(
                layout, g, pv, out_dtype=torch.bfloat16 if x3 else blocks.dtype)
            if x3:
                bar_blocks = torch.stack([bar_blocks, bar_blocks], dim=0)
        return None, bar_blocks, bar_pv


class _BlockMatvecEdge(torch.autograd.Function):
    """out = M(qblocks) @ pv with the cotangent contracted to edge space at
    once: K3 in f32, then the transpose of ``assemble``'s scatter (a gather
    at ``edge_flat`` / ``diag_flat``), so at most one panel-shaped buffer is
    live and sums across solves happen in O(M + N) memory."""

    @staticmethod
    def forward(ctx, layout, qblocks, diag, triu, pv):
        pv = pv.contiguous()
        ctx.layout = layout
        ctx.save_for_backward(qblocks, pv)
        return _run_block_kernel(layout, qblocks, pv)

    @staticmethod
    def backward(ctx, g):
        qblocks, pv = ctx.saved_tensors
        layout = ctx.layout
        g = g.to(pv.dtype).contiguous()
        bar_diag = bar_triu = bar_pv = None
        if ctx.needs_input_grad[4]:
            bar_pv = _run_block_kernel(layout, qblocks, g)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            flat = block_bwd_blocks(layout, g, pv, out_dtype=torch.float32).reshape(-1)
            if ctx.needs_input_grad[3]:
                e = flat[layout.edge_flat]  # [2M]
                m = e.shape[0] // 2
                # assemble scatters (-triu, -triu, diag): transpose accordingly
                bar_triu = -(e[:m] + e[m:])
            if ctx.needs_input_grad[2]:
                bar_diag = flat[layout.diag_flat]
        return None, None, bar_diag, bar_triu, bar_pv


def make_matvec_ad(layout: BlockLayout):
    """Differentiable block matvec ``mv(blocks, pv) -> L @ pv`` in permuted
    space (f32, bf16 or x3 panels), with panel-space cotangents."""

    def mv(blocks, pv):
        return _BlockMatvec.apply(layout, blocks, pv)

    return mv


def make_matvec_edge_ad(layout: BlockLayout):
    """Differentiable block matvec with EDGE-SPACE cotangents:
    ``mv(qblocks, diag, triu, pv)``.

    Caller contract: ``qblocks == assemble(layout, diag, triu, dtype=...)``
    (up to the panel type cast), detached: the forward uses only
    ``qblocks`` while the backward claims the mathematically equivalent
    dependence on (diag, triu) and returns no gradient for ``qblocks``. The
    panel cotangent is always accumulated in f32 (for bf16/x3 panels
    slightly more accurate than the panel path's bf16 cotangent)."""

    def mv(qblocks, diag, triu, pv):
        return _BlockMatvecEdge.apply(layout, qblocks, diag, triu, pv)

    return mv
