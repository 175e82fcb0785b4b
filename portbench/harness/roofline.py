"""The kernels' operation and byte counts and the card's peaks, frozen here.

Copied from ``manifold_gp_torch/utils/roofline.py`` (``matvec_bytes``,
``matvec_flops``, ``bwd_blocks_bytes``, ``bound_ms`` and the peak table),
so that a change to the program cannot change the yardstick. The counts
describe the work an apply needs, whatever kernel implements it: each input
read once, each output written once. A bound is the larger of the bytes
over the card's memory rate and the operations over its peak rate for their
type (f32 panels and bands: IEEE f32 FMA, TF32 off; bf16 panels: the bf16
tensor cores).
"""

from __future__ import annotations

from typing import Optional

BLOCK = 128  # block-ELL panel edge

# HBM bytes/s, f32 FLOP/s outside the tensor cores, bf16 tensor FLOP/s
# (NVIDIA data sheets, dense, at the full power limit), matched in this
# order against the card's name ("H100" last: the SXM card).
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),
}


def card_peaks(name: str) -> Optional[tuple]:
    """(HBM bytes/s, f32 FLOP/s, bf16 FLOP/s) of the card named ``name``,
    or None for a card not in the table."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    return None


def bound_s(nbytes: float, flops: float, peaks: tuple, bf16: bool) -> float:
    """The least seconds of work moving ``nbytes`` and doing ``flops``."""
    hbm, f32, tensor = peaks
    return max(nbytes / hbm, flops / (tensor if bf16 else f32))


def block_fwd(spec: dict, batch: int, panel_bytes: int) -> tuple:
    """(bytes, flops) of one block-ELL forward apply at width ``batch``:
    the panels, the block-id table, the f32 operand and the f32 output."""
    nrb, s, npd = spec["nrb"], spec["s_max"], spec["num_padded"]
    nbytes = (nrb * BLOCK * s * BLOCK * panel_bytes + nrb * s * 4 + npd * batch * 4
              + nrb * BLOCK * batch * 4)
    return nbytes, 2 * nrb * BLOCK * s * BLOCK * batch


def block_bwd(spec: dict, batch: int, out_bytes: int) -> tuple:
    """(bytes, flops) of one panel cotangent (kernel K3) at width ``batch``:
    the panel-sized output written once, the f32 output cotangent, the f32
    operand and the block-id table read once."""
    nrb, s, npd = spec["nrb"], spec["s_max"], spec["num_padded"]
    nbytes = (nrb * BLOCK * s * BLOCK * out_bytes + nrb * BLOCK * batch * 4 + npd * batch * 4
              + nrb * s * 4)
    return nbytes, 2 * nrb * BLOCK * s * BLOCK * batch


def dia_fwd(spec: dict, batch: int, band_bytes: int) -> tuple:
    """(bytes, flops) of one DIA apply (kernel K4) at width ``batch``: the
    band as the kernel stores it ([Npd, D]), the f32 operand and output."""
    npd, d = spec["num_padded"], spec["num_offsets"]
    return npd * d * band_bytes + 2 * npd * batch * 4, 2 * npd * d * batch
