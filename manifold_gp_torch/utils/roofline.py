"""Speed-of-light (roofline) accounting of the SpMV and CG work (port of
``manifold_gp_tpu.utils.roofline``).

The byte and FLOP models describe the work of one Laplacian apply (and of
one CG iteration around it), whatever kernel implements it; the peaks are
the card's. A bound is the larger of two times: the bytes the apply must
move over the card's memory rate, and its operations over the card's peak
rate for their type (f32 panels and bands: IEEE f32 FMA, TF32 off; bf16
panels, and the stacked bf16 hi/lo "x3" panels: the bf16 tensor cores).

Byte model of one apply (``matvec_bytes``), each part read or written once
(and of the cotangents K3 and K5 write, ``bwd_blocks_bytes`` and
``band_grad_bytes``):
  * block-ELL: the panels (``buf_dtype_bytes`` per entry), the operand and
    the output; the int32 block-id table beside them (``index``, not in
    ``total``, as in JAX's model; a kernel's bound adds it);
  * DIA: the band, the operand and the output.
``streaming=True`` counts instead an operand re-read for every row block
(block-ELL: S column blocks per row block; DIA: each tile's window with its
two halos), the JAX model of its streaming kernels.

The peaks (NVIDIA data sheets, dense, at the full power limit) are keyed on
``torch.cuda.get_device_name``; without a card, or for a card not in the
table, they are None and the roofline fields are left out, not faked.
"""

from __future__ import annotations

from typing import Optional

from ..ops.block_sparse import BLOCK, BlockLayout
from ..ops.dia import BAND_WIDTH, TILE, DiaLayout

# HBM bytes/s, f32 FLOP/s outside the tensor cores, bf16 tensor FLOP/s;
# matched in this order against the card's name ("H100" last: the SXM card)
_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM (80GB HBM3)
}


def card_peaks(name: Optional[str] = None):
    """(table key, (HBM bytes/s, f32 FLOP/s, bf16 FLOP/s)) of the card
    named ``name`` (default: CUDA device 0's name), or None without a card
    or for a card not in the table."""
    if name is None:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    for key, val in _PEAKS.items():
        if key in name:
            return key, val
    return None


def hbm_peak_bytes_per_s(name: Optional[str] = None) -> Optional[float]:
    """Peak memory bandwidth of the card (None without one)."""
    peaks = card_peaks(name)
    return None if peaks is None else peaks[1][0]


def bound_ms(nbytes: float, flops: float, dtype_bytes: int = 4,
             name: Optional[str] = None):
    """(ms, "bytes" or "operations"): the least time of work moving
    ``nbytes`` and doing ``flops`` of the given operand type on the card;
    None without a card."""
    peaks = card_peaks(name)
    if peaks is None:
        return None
    hbm, f32, bf16 = peaks[1]
    t_bytes = nbytes / hbm * 1e3
    t_ops = flops / (f32 if dtype_bytes == 4 else bf16) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def normalize_spec(layout) -> dict:
    """Layout object (DiaLayout / BlockLayout / mesh tables with
    ``s_max`` + ``nrb`` + ``rows``) or spec dict -> canonical spec dict."""
    if isinstance(layout, dict):
        return layout
    if isinstance(layout, DiaLayout):
        return {"format": "dia", "num_padded": layout.num_padded,
                "num_offsets": layout.num_offsets, "halfwidth": layout.halfwidth}
    if isinstance(layout, BlockLayout):
        return {"format": "block", "nrb": layout.num_row_blocks, "s_max": layout.max_blocks,
                "num_padded": layout.num_padded}
    # duck-typed mesh tables (parallel.block_spmv.MeshBlockTables)
    return {"format": "block", "nrb": layout.nrb, "s_max": layout.s_max,
            "num_padded": layout.rows}


def matvec_flops(layout, batch: int, passes: int = 1) -> int:
    """FLOPs of one apply: block-ELL panels (``passes`` = 3 for x3 panels:
    hi·sh + hi·sl + lo·sh) or DIA bands."""
    spec = normalize_spec(layout)
    if spec["format"] == "dia":
        return 2 * spec["num_padded"] * spec["num_offsets"] * batch
    return passes * 2 * spec["nrb"] * BLOCK * spec["s_max"] * BLOCK * batch


def block_matvec_flops(layout, batch: int) -> Optional[int]:
    """FLOPs of one block-panel apply (None for DIA, as JAX's)."""
    spec = normalize_spec(layout)
    return None if spec["format"] != "block" else matvec_flops(spec, batch)


def matvec_bytes(layout, batch: int, *, operand_dtype_bytes: int = 4, buf_dtype_bytes: int = 4,
                 streaming: Optional[bool] = None, packed_band: bool = True) -> dict:
    """HBM bytes of ONE apply for ``layout``: {"format", "operator",
    "index", "operand", "output", "total"} (``total`` without ``index``). ``streaming`` (default False):
    the operand re-read per row block instead of once. ``packed_band``
    counts the band as the kernel stores it, [Npd, D]; False as a
    ``BAND_WIDTH``-wide band."""
    spec = normalize_spec(layout)
    if spec["format"] == "dia":
        npd, d, w = spec["num_padded"], spec["num_offsets"], spec["halfwidth"]
        operator = npd * (d if packed_band else BAND_WIDTH) * buf_dtype_bytes
        if streaming:
            operand = npd // TILE * (TILE + 2 * w) * batch * operand_dtype_bytes
        else:
            operand = npd * batch * operand_dtype_bytes
        output = npd * batch * operand_dtype_bytes
        return {"format": "dia", "operator": operator, "index": 0, "operand": operand,
                "output": output, "total": operator + operand + output}
    nrb, s, npd = spec["nrb"], spec["s_max"], spec["num_padded"]
    operator = nrb * BLOCK * s * BLOCK * buf_dtype_bytes
    index = nrb * s * 4
    if streaming:
        operand = nrb * s * BLOCK * batch * operand_dtype_bytes
    else:
        operand = npd * batch * operand_dtype_bytes
    output = nrb * BLOCK * batch * operand_dtype_bytes
    return {"format": "block-stream" if streaming else "block-resident", "operator": operator,
            "index": index, "operand": operand, "output": output,
            "total": operator + operand + output}


def bwd_blocks_bytes(layout, batch: int, *, out_dtype_bytes: int = 4,
                     operand_dtype_bytes: int = 4) -> dict:
    """HBM bytes of one panel cotangent ``bar_blocks[r] = g[r] @
    gathered_pv[r]'`` (kernel K3): the panel-sized output written once, the
    output cotangent, the operand and the block-id table read once. Its
    FLOPs are ``block_matvec_flops``."""
    spec = normalize_spec(layout)
    nrb, s, npd = spec["nrb"], spec["s_max"], spec["num_padded"]
    output = nrb * BLOCK * s * BLOCK * out_dtype_bytes
    cotangent = nrb * BLOCK * batch * operand_dtype_bytes
    operand = npd * batch * operand_dtype_bytes
    index = nrb * s * 4
    return {"output": output, "cotangent": cotangent, "operand": operand, "index": index,
            "total": output + cotangent + operand + index}


def band_grad_bytes(layout, batch: int, *, out_dtype_bytes: int = 4,
                    operand_dtype_bytes: int = 4) -> dict:
    """HBM bytes of one DIA band cotangent ``bar_band[i, d] = sum_b g[i, b]
    * pv[i + off_d, b]`` (kernel K5): the output cotangent and the operand
    read once, the ``BAND_WIDTH``-lane band written once (every lane, the
    padding's zeros too). Its FLOPs are ``matvec_flops``."""
    spec = normalize_spec(layout)
    npd = spec["num_padded"]
    cotangent = npd * batch * operand_dtype_bytes
    operand = npd * batch * operand_dtype_bytes
    output = npd * BAND_WIDTH * out_dtype_bytes
    return {"cotangent": cotangent, "operand": operand, "output": output,
            "total": cotangent + operand + output}


def cg_iter_bytes(layout, batch: int, nu: int, *, operand_dtype_bytes: int = 4,
                  buf_dtype_bytes: int = 4, streaming: Optional[bool] = None,
                  randomwalk: bool = True, jacobi: bool = False,
                  packed_band: bool = True) -> dict:
    """Modeled HBM bytes of ONE CG iteration on the Matérn precision
    Q = (shift I + L)^nu: nu applies plus the solver's vector passes
    (V = one [Npd, B] pass, each elementwise chain one read+write sweep):
      entry conjugation   read p, write t                    2V
      exit  conjugation   read t, write ap (+ fused p.ap)    2V (+1V read p)
      x,r updates + rs    read x,r,p,ap write x,r            6V
      p update            read r,p write p                   3V
      [jacobi] z = r/diag read r,diag write z                +2V
    (the conjugations only for the randomwalk normalization)."""
    mv = matvec_bytes(layout, batch, operand_dtype_bytes=operand_dtype_bytes,
                      buf_dtype_bytes=buf_dtype_bytes, streaming=streaming,
                      packed_band=packed_band)
    v_pass = normalize_spec(layout)["num_padded"] * batch * operand_dtype_bytes
    passes = 9.0 + (4.0 if randomwalk else 0.0) + (2.0 if jacobi else 0.0)
    vector = passes * v_pass
    return {"format": mv["format"], "kernel": nu * mv["total"], "kernel_per_apply": mv["total"],
            "operator_per_apply": mv["operator"], "vector": vector,
            "total": nu * mv["total"] + vector}


def roofline_fields(layout, batch: int, nu: int, measured_matvecs_per_s: float, *,
                    operand_dtype_bytes: int = 4, buf_dtype_bytes: int = 4,
                    streaming: Optional[bool] = None, randomwalk: bool = True,
                    jacobi: bool = False, name: Optional[str] = None,
                    packed_band: bool = True) -> dict:
    """The fields a CG rate row carries. ``measured_matvecs_per_s`` counts
    Laplacian-equivalent matvecs (batch columns x nu applies per CG
    iteration):

    * ``bytes_per_matvec_kernel``: the apply's bytes per batch column;
    * ``bytes_per_matvec_solver_model``: with the CG vector passes;
    * ``kernel_share``: the applies' share of the modeled bytes;
    * ``achieved_gbps``: solver-model bytes times the measured rate;
    * with a card in the table: ``hbm_peak_gbps``, ``pct_of_hbm_peak``,
      ``sol_matvecs_per_s_kernel`` (the rate of an implementation paying
      only the applies' bytes) and ``pct_of_sol_kernel``.
    """
    it = cg_iter_bytes(layout, batch, nu, operand_dtype_bytes=operand_dtype_bytes,
                       buf_dtype_bytes=buf_dtype_bytes, streaming=streaming,
                       randomwalk=randomwalk, jacobi=jacobi, packed_band=packed_band)
    bytes_solver = it["total"] / (nu * batch)
    bytes_kernel = it["kernel_per_apply"] / batch
    achieved = measured_matvecs_per_s * bytes_solver
    out = {"spmv_format": it["format"],
           "bytes_per_matvec_kernel": round(bytes_kernel, 1),
           "bytes_per_matvec_solver_model": round(bytes_solver, 1),
           "kernel_share": round(it["kernel"] / it["total"], 3),
           "achieved_gbps": round(achieved / 1e9, 1)}
    peak = hbm_peak_bytes_per_s(name)
    if peak:
        sol_kernel = peak / bytes_kernel
        out["hbm_peak_gbps"] = round(peak / 1e9, 1)
        out["pct_of_hbm_peak"] = round(100.0 * achieved / peak, 1)
        out["sol_matvecs_per_s_kernel"] = round(sol_kernel, 1)
        out["pct_of_sol_kernel"] = round(100.0 * measured_matvecs_per_s / sol_kernel, 1)
    return out
