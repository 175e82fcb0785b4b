"""Inference configuration and device selection.

``InferenceConfig`` keeps every field of ``manifold_gp_tpu.config`` with the
same defaults, so one configuration describes a run in either package. The
one field whose values differ is ``spmv_kernel``: the fused block-ELL SpMV is
the hand-written CUDA kernel of ``ops.cuda_spmv`` here, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import torch

SPMV_KERNELS = ("auto", "cuda")


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Settings for the matrix-free inference engine (field meanings as in
    ``manifold_gp_tpu.config.InferenceConfig``).

    ``spmv_kernel``: the device alone picks the block-ELL product: the CUDA
    kernel for CUDA tensors, its plain PyTorch version for CPU tensors.
    "auto" accepts both; "cuda" asserts the kernel (a CPU kernel object
    raises at construction).
    """

    max_cholesky: int = 800
    cg_tolerance: float = 1e-2
    cg_max_iter: int = 1000
    num_probes: int = 64
    lanczos_max_iter: int = 96
    eigh_max_size: int = 8192
    eigensolver_max_iter: int = 200
    eigensolver: str = "lobpcg"
    cheb_degree: int = 256
    cheb_iters: int = 6
    dense_operator_max_size: int = 4096
    use_block_sparse: bool = True
    use_dia: bool = True
    dia_max_offsets: int = 24
    spmv_dtype: str = "float32"
    cg_precondition: bool = True
    precond_type: str = "jacobi"
    precond_rank: int = 15
    slq_precond_quadrature: bool = False
    spmv_kernel: str = "auto"
    solve_cotangent: str = "panel"
    dense_gram_max_size: int = 20000

    def __post_init__(self):
        if self.spmv_kernel not in SPMV_KERNELS:
            raise ValueError(
                f"spmv_kernel must be one of {SPMV_KERNELS}, got {self.spmv_kernel!r}"
            )

    def replace(self, **kw) -> "InferenceConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = InferenceConfig()


def resolve_device(device="cuda") -> torch.device:
    """The device a port entry point runs on. CUDA is the default; asking for
    it without a card raises instead of continuing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "manifold_gp_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
