"""Block-ELL Laplacian SpMV on Hopper: the CUDA kernel that replaces the
Pallas kernels K1/K2 of ``manifold_gp_tpu.ops.pallas_spmv``.

The kernel (``csrc/block_ell_spmv.cu``) is CUDA C++ compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface and loaded with ``ctypes``, at first use, into
``manifold_gp_torch/build/`` (named by a hash of the source, so an edited
source rebuilds). Nothing is built or loaded when this module is imported.

Dispatch: for CUDA tensors the wrappers launch the kernel or raise; for CPU
tensors they run ``block_matvec_plain``, the same arithmetic in PyTorch
(gather, then a batched product, with the x3 products spelled out). There is
no fallback from a CUDA tensor to the plain version.

On the TPU, K1 (operand resident in VMEM) and K2 (operand streamed from HBM)
differ only in where the operand lives; on a GPU it always lives in device
memory with L2 as its cache, so K1 and K2 merge into one kernel:
``resident_matvec_call`` and ``stream_matvec_call`` are two names for one
entry point, and ``_run_block_kernel`` has no size switch. Neither the
8 MiB VMEM budget nor the pad-to-128 batch requirement carries over: the
kernel masks a ragged batch edge itself.

``launch_count`` counts kernel launches (incremented only where the kernel
is launched), so a run can show that its main path went through the kernel.
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

from .block_sparse import BLOCK, BlockLayout, check_block_cols, permute_in, permute_out

# Number of kernel launches since the last reset (set it to 0 to reset).
launch_count = 0

_SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "block_ell_spmv.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
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
    raise RuntimeError("block_ell_spmv: nvcc not found (needed to build the CUDA kernel)")


def build_library() -> pathlib.Path:
    """Compile the kernel source into the package's build directory (once
    per source content) and return the library path."""
    global build_log
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libblock_ell_spmv-{digest}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"block_ell_spmv: nvcc failed:\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.block_ell_spmv
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
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
            nrb, s_max, batch, mode, stream,
        )
    if err != 0:
        raise RuntimeError(f"block_ell_spmv: launch failed with cudaError {err}")
    launch_count += 1
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
