"""Kernel K5 (the DIA band cotangent, ``csrc/dia_band_grad.cu``) on the
card against its plain version ``bar_band_plain`` and against the same sum
in float64: f32 and bf16 bands, B = 1, 3, 100, 128 and 200 (the row
template, a ragged float4 group, the average variance's and the probes'
widths, two 128-column chunks), on the k = 16 curves' filled offsets (the
window template) and on two gapped layouts (the general template).

Needs an NVIDIA card and ``nvcc`` (marker ``cuda``); skips without them.
Imports nothing of JAX and uses no fixture of ``tests/conftest.py`` (which
imports JAX), so where JAX is not installed it runs without the conftest:

    python -m pytest --noconftest tests/test_torch_dia_cuda.py -q
"""

import numpy as np
import pytest
import torch

from manifold_gp_torch.ops import cuda_spmv
from manifold_gp_torch.ops import dia as tdia

pytestmark = pytest.mark.cuda

CURVE_OFFSETS = tuple(range(-21, 22))  # the k = 16 curves' layout: D = 43 = 2W + 1
LAYOUTS = {"curve": CURVE_OFFSETS, "gapped": tdia.GAPPED_OFFSETS,
           "spread": tdia.spread_offsets()}
N = 3000  # true rows: six 512-row tiles, the padded space of a few thousand rows
SUM_ORDER = 1e-5  # of max |plain|: f32 sums in another order
BF16_STEP = 2.0 ** -7  # bf16 band: one rounding step where the two f32 sums straddle it


@pytest.fixture(scope="module")
def card():
    """The CUDA device with the kernel library built and loaded; skips
    without a card or without nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    try:
        cuda_spmv._nvcc()
    except RuntimeError as exc:
        pytest.skip(f"needs nvcc to build the kernels: {exc}")
    cuda_spmv._load()
    return torch.device("cuda")


def _case(name, batch, seed, device):
    """A layout in band order, an operand and an output cotangent with zero
    halo rows (the solver path's), on ``device``."""
    lay = tdia.layout_from_offsets(LAYOUTS[name], N, device=device)
    rng = np.random.default_rng(seed)
    g = np.zeros((lay.num_padded, batch), np.float32)
    pv = np.zeros((lay.num_padded, batch), np.float32)
    g[tdia.TILE:tdia.TILE + N] = rng.standard_normal((N, batch))
    pv[tdia.TILE:tdia.TILE + N] = rng.standard_normal((N, batch))
    return lay, torch.from_numpy(g).to(device), torch.from_numpy(pv).to(device)


def _rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("band_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 3, 100, 128, 200])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_k5_matches_plain_and_float64(card, monkeypatch, name, batch, band_dtype):
    """K5 against ``bar_band_plain`` on the card and against float64: its
    error is no larger than the plain version's, to one rounding of the
    largest entry in the band's type; halo rows and lanes past D are
    exactly 0; two calls agree bit for bit; no ``torch.roll`` runs."""
    lay, g, pv = _case(name, batch, seed=batch, device=card)
    plan = tdia.band_grad_plan(lay.offsets, lay.halfwidth, batch)
    assert plan.template == ("row" if batch == 1 else "window" if name == "curve" else "general")
    plain = tdia.bar_band_plain(lay, g, pv, band_dtype)
    exact = tdia.bar_band_plain(lay, g.double(), pv.double(), torch.float64)

    def no_roll(*args, **kwargs):
        raise AssertionError("torch.roll ran on the CUDA path")

    before = tdia.dia_band_grad_launch_count
    with monkeypatch.context() as m:
        m.setattr(torch, "roll", no_roll)
        got = tdia.bar_band(lay, g, pv, band_dtype)
        again = tdia.bar_band(lay, g, pv, band_dtype)
    torch.cuda.synchronize()
    assert tdia.dia_band_grad_launch_count == before + 2
    assert got.dtype == band_dtype and tuple(got.shape) == (lay.num_padded, tdia.BAND_WIDTH)
    assert torch.equal(got, again)
    assert not got[:, lay.num_offsets:].any()
    assert not got[:tdia.TILE].any() and not got[tdia.TILE + N:].any()
    step = 2.0 ** -24 if band_dtype == torch.float32 else 2.0 ** -9
    assert _rel_err(got, exact) <= _rel_err(plain, exact) + step
    tol = SUM_ORDER if band_dtype == torch.float32 else BF16_STEP
    assert _rel_err(got, plain.double()) <= tol


@pytest.mark.parametrize("band_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_matvec_band_gradient_on_the_card_equals_the_cpu_plain_path(card, band_dtype):
    """``make_matvec_ad``'s band gradient through K5 (and its operand
    gradient through K4) against the same graph of calls on CPU tensors,
    which runs the plain versions."""
    grads = {}
    for device in ("cpu", card):
        lay, g, pv = _case("curve", 128, seed=7, device=device)
        rng = np.random.default_rng(8)
        lanes = np.zeros((lay.num_padded, tdia.BAND_WIDTH), np.float32)
        lanes[tdia.TILE:tdia.TILE + N, :lay.num_offsets] = rng.standard_normal(
            (N, lay.num_offsets))
        band = torch.from_numpy(lanes).to(device=device, dtype=band_dtype).requires_grad_(True)
        pvr = pv.clone().requires_grad_(True)
        tdia.make_matvec_ad(lay)(band, pvr).backward(g)
        grads[str(device)] = (band.grad.cpu().double(), pvr.grad.cpu().double())
    tol = SUM_ORDER if band_dtype == torch.float32 else BF16_STEP
    for (cpu, gpu) in zip(grads["cpu"], grads["cuda"]):
        assert float((gpu - cpu).abs().max()) <= tol * float(cpu.abs().max())


def test_k5_launches_are_counted_while_tracing(card):
    """``dia.band_grad.<template>`` counts K5's launches while a profiler
    records, one per launch, and nothing otherwise."""
    from torch.profiler import ProfilerActivity, profile

    from manifold_gp_torch.utils import metrics

    lay, g, pv = _case("curve", 128, seed=2, device=card)
    lay1, g1, pv1 = _case("gapped", 1, seed=2, device=card)
    metrics.reset()
    try:
        tdia.bar_band(lay, g, pv, torch.float32)
        assert metrics.traced()["counters"] == {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                tdia.bar_band(lay, g, pv, torch.float32)
            tdia.bar_band(lay1, g1, pv1, torch.bfloat16)
            torch.cuda.synchronize()
        assert metrics.traced()["counters"] == {"dia.band_grad.window": 2,
                                                "dia.band_grad.row": 1}
    finally:
        metrics.reset()
    names = [e.name for e in prof.events() if "band_grad_" in e.name and "_kernel" in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3
    assert not any(k in n for n in names for k in ("dia_window_kernel", "dia_general_kernel",
                                                   "dia_row_kernel"))
