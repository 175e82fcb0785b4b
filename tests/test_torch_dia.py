"""Port vs JAX: the DIA band format (layout, assembly, the plain version of
kernel K4 and its autograd Function) and the training loss on a DIA layout.

The banded problem is ``tests/test_dia.py``'s: a k = 8 ring graph over a
noisy closed 3-D curve, built through both packages' ``graph_from_edges``
from the same numpy edges. Layout arrays and assembled bands must be EQUAL
(same RCM order, same slots, same scatter). Matvecs agree to f32 sum order:
one rounding per diagonal on both sides, in another order, so 1e-5 of
max|.| (values reach ~1e3: diag ~ 1/eps^2). The JAX side runs as its own
tests run it: ``matvec_permuted`` (XLA rolls) or ``dia_matvec_pallas`` in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from examples_torch.run_large import curve_points
from manifold_gp_tpu.ops import dia as jdia
from manifold_gp_tpu.ops import engine as jengine
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_tpu.ops import sparse_formats as jsf
from manifold_gp_torch.ops import dia as tdia
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import sparse_formats as tsf

TOL = 1e-5  # of max |expected|: f32 sum order


def _banded_edges(n=1500, k=8, seed=0):
    """tests/test_dia.py::banded_curve_graph's edges, as numpy arrays."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x = np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], axis=1).astype(np.float32)
    x += (0.1 / n) * rng.standard_normal(x.shape).astype(np.float32)
    half = max(1, k // 2)
    rows = np.repeat(np.arange(n, dtype=np.int64), half)
    cols = (rows + np.tile(np.arange(1, half + 1, dtype=np.int64), n)) % n
    d = x[rows] - x[cols]
    sqd = np.einsum("ij,ij->i", d, d).astype(np.float32)
    return np.minimum(rows, cols), np.maximum(rows, cols), sqd, n


@pytest.fixture(scope="module")
def problem():
    r, c, sqd, n = _banded_edges()
    jg = jgraph.graph_from_edges(r, c, sqd, n)
    tg = tgraph.graph_from_edges(r, c, sqd, n, device="cpu")
    jc = jlap.laplacian_coeffs(jg, 0.05)
    jl = jdia.build_dia_layout(jg)
    tl = tdia.build_dia_layout(tg)
    assert jl is not None and tl is not None
    diag, triu = np.array(jc.diag), np.array(jc.triu)
    lap = (sp.diags(diag.astype(np.float64))
           - sp.coo_matrix((triu.astype(np.float64), (r, c)), (n, n))
           - sp.coo_matrix((triu.astype(np.float64), (c, r)), (n, n))).tocsr()
    return jl, tl, diag, triu, lap


def _v(rows, batch, seed):
    return np.random.default_rng(seed).standard_normal((rows, batch)).astype(np.float32)


def test_layout_equal_to_jax(problem):
    jl, tl, *_ = problem
    for name in ("offsets", "num_nodes", "num_padded", "halfwidth", "num_offsets"):
        assert getattr(tl, name) == getattr(jl, name), name
    for name in ("perm", "unperm", "edge_flat", "diag_flat"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                      err_msg=name)
    assert (tdia.TILE, tdia.BAND_WIDTH) == (jdia.TILE, jdia.BAND_WIDTH)
    assert all(isinstance(o, int) for o in tl.offsets)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assemble_equal_to_jax(problem, dtype):
    jl, tl, diag, triu, _ = problem
    jb = jdia.assemble(jl, jnp.asarray(diag), jnp.asarray(triu),
                       dtype=None if dtype == "float32" else jnp.bfloat16)
    tb = tdia.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu),
                       dtype=None if dtype == "float32" else torch.bfloat16)
    assert tuple(tb.shape) == (tl.num_padded, tdia.BAND_WIDTH)
    assert str(tb.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb, np.float32))
    # through the dispatcher, x3 keeps exact f32 bands as in JAX
    np.testing.assert_array_equal(
        tsf.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu), "float32x3").numpy(),
        np.asarray(jsf.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), "float32x3")))


@pytest.mark.parametrize("band_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 37])
def test_matvec_matches_jax_and_coo(problem, band_dtype, batch):
    jl, tl, diag, triu, lap = problem
    tdt = None if band_dtype == "float32" else torch.bfloat16
    jdt = None if band_dtype == "float32" else jnp.bfloat16
    tb = tdia.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu), dtype=tdt)
    jb = jdia.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), dtype=jdt)
    v = _v(tl.num_nodes, batch, seed=batch)
    tpv = tdia.permute_in(tl, torch.from_numpy(v))
    jpv = jdia.permute_in(jl, jnp.asarray(v))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    want = np.asarray(jdia.matvec_permuted(jl, jb, jpv))
    scale = np.abs(want).max()
    tdia.dia_launch_count = 0
    for got in (tdia.matvec_permuted(tl, tb, tpv), tdia.dia_matvec_call(tl, tb, tpv),
                tsf.matvec_permuted(tl, tb, tpv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)
    assert tdia.dia_launch_count == 0  # CPU tensors: the plain version ran
    # both against the COO oracle in f64 (on the band's own values)
    if band_dtype == "float32":
        oracle = lap @ v.astype(np.float64)
        got = tsf.matvec(tl, tb, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL * np.abs(oracle).max())
        np.testing.assert_allclose(np.asarray(jdia.permute_out(jl, jnp.asarray(want))), oracle,
                                   rtol=0, atol=TOL * np.abs(oracle).max())


def test_matvec_matches_jax_pallas_interpret(problem):
    """The JAX kernel itself (interpret mode; its batch is a multiple of 128)."""
    jl, tl, diag, triu, _ = problem
    tb = tdia.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu))
    jb = jdia.assemble(jl, jnp.asarray(diag), jnp.asarray(triu))
    v = _v(tl.num_nodes, 128, seed=5)
    want = np.asarray(jdia.dia_matvec_pallas(jl, jb, jdia.permute_in(jl, jnp.asarray(v)),
                                             interpret=True))
    got = tdia.dia_matvec_call(tl, tb, tdia.permute_in(tl, torch.from_numpy(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("band_dtype", ["float32", "bfloat16"])
def test_matvec_ad_forward_and_vjp_match_jax(problem, band_dtype):
    """Forward, bar_band and bar_pv of ``make_matvec_ad`` against jax.grad
    through the JAX matvec; and the gradient through ``assemble`` back to
    (diag, triu), the transpose of the scatter."""
    jl, tl, diag, triu, _ = problem
    tdt = None if band_dtype == "float32" else torch.bfloat16
    jdt = None if band_dtype == "float32" else jnp.bfloat16
    v = _v(tl.num_nodes, 16, seed=11)
    cot = _v(tl.num_padded, 16, seed=12)
    cot[:tdia.TILE] = 0.0  # cotangents of halo/pad rows are zero on the solver path
    cot[tdia.TILE + tl.num_nodes:] = 0.0

    def jloss(d, t, pv):
        return jnp.sum(jdia.matvec_permuted(jl, jdia.assemble(jl, d, t, dtype=jdt), pv)
                       * jnp.asarray(cot))

    jpv = jdia.permute_in(jl, jnp.asarray(v))
    jfwd = np.asarray(jdia.matvec_permuted(jl, jdia.assemble(jl, jnp.asarray(diag),
                                                             jnp.asarray(triu), dtype=jdt), jpv))
    jgd, jgt, jgp = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(diag), jnp.asarray(triu), jpv)
    jband = jdia.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), dtype=jdt)
    jgb = jax.grad(lambda b: jnp.sum(jdia.matvec_permuted(jl, b, jpv) * jnp.asarray(cot)))(jband)

    td = torch.from_numpy(diag).requires_grad_(True)
    tt = torch.from_numpy(triu).requires_grad_(True)
    tpv = tdia.permute_in(tl, torch.from_numpy(v)).requires_grad_(True)
    tband = tdia.assemble(tl, td, tt, dtype=tdt)
    tband.retain_grad()
    out = tsf.make_matvec_ad(tl)(tband, tpv)
    np.testing.assert_allclose(out.detach().numpy(), jfwd, rtol=0,
                               atol=TOL * np.abs(jfwd).max())
    torch.sum(out * torch.from_numpy(cot)).backward()
    for name, got, want in (("bar_band", tband.grad.float(), np.asarray(jgb, np.float32)),
                            ("bar_pv", tpv.grad, jgp), ("bar_diag", td.grad, jgd),
                            ("bar_triu", tt.grad, jgt)):
        want = np.asarray(want, np.float32)
        tol = TOL if band_dtype == "float32" else 2.0 ** -7  # one bf16 rounding apart
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max(),
                                   err_msg=name)
    assert not tband.grad.float()[:, tl.num_offsets:].any()  # padding lanes


def test_unbanded_cloud_gets_no_dia_layout():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    x = centers[rng.integers(0, 4, 600)] + 0.2 * rng.standard_normal((600, 8)).astype(np.float32)
    assert jdia.build_dia_layout(jgraph.build_graph(x, 8), max_offsets=16) is None
    assert tdia.build_dia_layout(tgraph.build_graph(x, 8, device="cpu"), max_offsets=16) is None


def test_wrapper_rejects_what_the_kernel_does_not_take(problem):
    _, tl, diag, triu, _ = problem
    band = tdia.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu))
    pv = torch.zeros(tl.num_padded, 4)
    before = tdia.dia_launch_count
    with pytest.raises(ValueError, match="band"):
        tdia.dia_matvec_call(tl, band[:, :64].contiguous(), pv)
    with pytest.raises(ValueError, match="band"):
        tdia.dia_matvec_call(tl, band.double(), pv)
    with pytest.raises(ValueError, match="operand"):
        tdia.dia_matvec_call(tl, band, torch.zeros(tl.num_padded + 512, 4))
    with pytest.raises(ValueError, match="empty"):
        tdia.dia_matvec_call(tl, band, torch.zeros(tl.num_padded, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tdia.dia_matvec_cuda(tl, band, pv)
    assert tdia.dia_launch_count == before  # counted only where K4 launches


# -- K4's launch plan and the plain version on gapped layouts ----------------

K8_OFFSETS = tuple(range(-10, 11))  # the k = 8 curves' layout: D = 21 = 2W + 1


def _plan_smem(plan, offsets, halfwidth, batch, itemsize, extra_rows=0):
    return tdia.block_smem(plan.template, len(offsets), halfwidth, batch, itemsize,
                           plan.rows_per_block + extra_rows)


@pytest.mark.parametrize("template,d,w,batch,itemsize,rows,want", [
    ("window", 21, 10, 128, 4, 64, (64 + 20) * 512 + 64 * 96),  # the curve at B = 128
    ("window", 21, 10, 100, 4, 80, (80 + 20) * 400 + 80 * 96),  # 25 float4 groups
    ("window", 21, 10, 200, 2, 64, (64 + 20) * 512 + 64 * 48),  # a 128-column chunk; bf16
    ("window", 21, 10, 3, 4, 8, (8 + 20) * 16 + 8 * 96),  # one ragged group
    ("general", 9, 512, 128, 4, 128, 128 * 48),  # band lanes only, 12 f32 a row
    ("general", 128, 512, 37, 2, 64, 64 * 256),
    ("row", 21, 10, 1, 4, 256, 0),
])
def test_block_smem(template, d, w, batch, itemsize, rows, want):
    """K4's shared memory per block: the window [TR + 2W, 4 x groups] f32
    before the band lanes [TR, D] padded to 16-byte pieces."""
    assert tdia.block_smem(template, d, w, batch, itemsize, rows) == want


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 17, 33, 37, 64, 99, 100, 127, 128, 129, 200])
def test_dia_plan_at_the_chip_check_widths(batch):
    """The k = 8 curve (offsets -10 .. 10): B = 1 takes the row template;
    wider batches the window template, 8 rows a thread, about one row group
    per thread where the shared-memory budget of two blocks per SM allows
    (at a few columns it caps the row run)."""
    for itemsize in (4, 2):
        plan = tdia.dia_plan(K8_OFFSETS, 10, batch, itemsize)
        if batch == 1:
            assert plan == tdia.DiaPlan("row", 1, 256)
            continue
        assert plan.template == "window" and plan.rows_per_thread == 8
        assert plan.rows_per_block % 8 == 0
        groups = -(-min(batch, 128) // 4)
        items = plan.rows_per_block // 8 * groups
        assert items <= 256
        assert _plan_smem(plan, K8_OFFSETS, 10, batch, itemsize) <= tdia._SMEM_BUDGET
        if items <= 256 - groups:  # short of a row group per thread: the budget's cap
            assert _plan_smem(plan, K8_OFFSETS, 10, batch, itemsize, 8) > tdia._SMEM_BUDGET
    # above 128 columns the block covers a 128-column chunk: same plan
    if batch > 128:
        assert tdia.dia_plan(K8_OFFSETS, 10, batch) == tdia.dia_plan(K8_OFFSETS, 10, 128)


@pytest.mark.parametrize("offsets,halfwidth", [
    (tdia.GAPPED_OFFSETS, 512),
    (tdia.spread_offsets(), 512),
    (tuple(o for o in range(-10, 11) if o != 3), 10),  # one gap
    (tuple(range(-512, 512, 8)), 512),  # D = 128, every 8th shift
])
def test_dia_plan_sends_unfilled_layouts_to_the_general_template(offsets, halfwidth):
    for batch in (2, 37, 128, 200):
        plan = tdia.dia_plan(offsets, halfwidth, batch)
        assert plan.template == "general" and plan.rows_per_thread == 8
        assert plan.rows_per_block % 8 == 0
        assert _plan_smem(plan, offsets, halfwidth, batch, 4) <= tdia._SMEM_BUDGET
    assert tdia.dia_plan(offsets, halfwidth, 1).template == "row"


def test_dia_plan_takes_the_window_for_every_filled_layout():
    """Offsets exactly -W .. W take the window template at every width (with
    D <= 128, W <= 63 and the window fits); the row runs chosen on the card
    for the curves' main widths are 64 rows at B = 128 and 80 at B = 100."""
    for w in (0, 10, 21, 33, 63):
        offsets = tuple(range(-w, w + 1))
        for batch in (2, 5, 17, 100, 128, 200):
            for itemsize in (4, 2):
                plan = tdia.dia_plan(offsets, w, batch, itemsize)
                assert plan.template == "window"
                assert plan.rows_per_block % plan.rows_per_thread == 0
                assert _plan_smem(plan, offsets, w, batch, itemsize) <= tdia._SMEM_BUDGET
    for w in (10, 21, 33):
        offsets = tuple(range(-w, w + 1))
        assert tdia.dia_plan(offsets, w, 128).rows_per_block == 64
        assert tdia.dia_plan(offsets, w, 100).rows_per_block == 80
    assert tdia.dia_plan((0,), 0, 5) == tdia.DiaPlan("window", 8, 1024)


@pytest.mark.parametrize("batch", [0, -1])
def test_dia_plan_refuses_empty_batches(batch):
    with pytest.raises(ValueError, match="batch"):
        tdia.dia_plan(K8_OFFSETS, 10, batch)


def test_layout_from_offsets():
    lay = tdia.layout_from_offsets((7, -300, 0, 512, -1), 3000, device="cpu")
    assert lay.offsets == (-300, -1, 0, 7, 512)
    assert (lay.halfwidth, lay.num_offsets, lay.num_nodes) == (512, 5, 3000)
    assert lay.num_padded % tdia.TILE == 0 and lay.num_padded >= tdia.TILE + 3000 + 512
    v = torch.arange(3000.0)[:, None]
    pv = tdia.permute_in(lay, v)
    assert not pv[:tdia.TILE].any() and not pv[tdia.TILE + 3000:].any()
    np.testing.assert_array_equal(tdia.permute_out(lay, pv).numpy(), v.numpy())
    band = tdia.assemble(lay, torch.ones(3000), torch.zeros(0))
    assert band[tdia.TILE:tdia.TILE + 3000, 2].eq(1).all() and band.sum() == 3000
    for bad in ((-1, 1), (0, 513), (0, 0, 1)):
        with pytest.raises(ValueError, match="offsets"):
            tdia.layout_from_offsets(bad, 100)


@pytest.mark.parametrize("name", ["gapped", "wide"])
@pytest.mark.parametrize("batch", [1, 37])
def test_matvec_permuted_matches_csr_on_gapped_layouts(name, batch):
    """The plain version K4 is held to on the card, on layouts that take
    K4's general template (W = 512): against a scipy CSR product built from
    the band's entries (random lanes in the true rows, zero halo rows)."""
    offsets = tdia.GAPPED_OFFSETS if name == "gapped" else tdia.spread_offsets()
    n = 3000
    lay = tdia.layout_from_offsets(offsets, n, device="cpu")
    d, npd = lay.num_offsets, lay.num_padded
    rng = np.random.default_rng(d)
    band = np.zeros((npd, tdia.BAND_WIDTH), np.float32)
    band[tdia.TILE:tdia.TILE + n, :d] = rng.standard_normal((n, d))
    pv = np.zeros((npd, batch), np.float32)
    pv[tdia.TILE:tdia.TILE + n] = rng.standard_normal((n, batch))
    rows = np.repeat(np.arange(npd), d)
    cols = rows + np.tile(np.asarray(lay.offsets), npd)
    vals = band[:, :d].ravel().astype(np.float64)
    keep = (vals != 0) & (cols >= 0) & (cols < npd)
    csr = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(npd, npd))
    want = csr @ pv.astype(np.float64)
    for got in (tdia.matvec_permuted(lay, torch.from_numpy(band), torch.from_numpy(pv)),
                tdia.dia_matvec_call(lay, torch.from_numpy(band), torch.from_numpy(pv))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


# -- K5, the band cotangent: plan, sizing, dispatch and counting -------------

CURVE_OFFSETS = tuple(range(-21, 22))  # the k = 16 curves' layout: D = 43 = 2W + 1


def _band_grad_case(offsets, n, batch, seed):
    """A layout in band order with these offsets, an operand with zero halo
    rows and an output cotangent with zero halo rows (the solver path's)."""
    lay = tdia.layout_from_offsets(offsets, n, device="cpu")
    rng = np.random.default_rng(seed)
    g = np.zeros((lay.num_padded, batch), np.float32)
    pv = np.zeros((lay.num_padded, batch), np.float32)
    g[tdia.TILE:tdia.TILE + n] = rng.standard_normal((n, batch))
    pv[tdia.TILE:tdia.TILE + n] = rng.standard_normal((n, batch))
    return lay, torch.from_numpy(g), torch.from_numpy(pv)


@pytest.mark.parametrize("band_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", [CURVE_OFFSETS, tdia.GAPPED_OFFSETS], ids=["curve", "gapped"])
def test_bar_band_on_cpu_takes_the_plain_path(offsets, band_dtype):
    """CPU tensors: ``bar_band`` is ``bar_band_plain`` (no launch), which
    matches a float64 sum over the operand's shifted rows."""
    lay, g, pv = _band_grad_case(offsets, 1100, 5, seed=len(offsets))
    before = tdia.dia_band_grad_launch_count
    got = tdia.bar_band(lay, g, pv, band_dtype)
    assert tdia.dia_band_grad_launch_count == before
    assert got.dtype == band_dtype and tuple(got.shape) == (lay.num_padded, tdia.BAND_WIDTH)
    assert torch.equal(got, tdia.bar_band_plain(lay, g, pv, band_dtype))
    g64, pv64 = g.double().numpy(), pv.double().numpy()
    want = np.zeros((lay.num_padded, tdia.BAND_WIDTH))
    rows = np.arange(lay.num_padded)
    for j, off in enumerate(lay.offsets):
        src = rows + off
        ok = (src >= 0) & (src < lay.num_padded)
        want[ok, j] = np.sum(g64[ok] * pv64[src[ok]], axis=1)
    tol = TOL if band_dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    assert not got[:, lay.num_offsets:].any()


def test_bar_band_rejects_what_the_kernel_does_not_take():
    lay, g, pv = _band_grad_case(tdia.GAPPED_OFFSETS, 1100, 3, seed=0)
    with pytest.raises(ValueError, match="band type"):
        tdia.bar_band(lay, g, pv, torch.float64)
    with pytest.raises(ValueError, match="operand"):
        tdia.bar_band(lay, g, pv.double(), torch.float32)
    with pytest.raises(ValueError, match="differ"):
        tdia.bar_band(lay, g[:, :2], pv, torch.float32)
    with pytest.raises(ValueError, match="empty"):
        tdia.bar_band(lay, g[:, :0], pv[:, :0], torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tdia.bar_band_cuda(lay, g, pv, torch.float32)


@pytest.mark.parametrize("template,d,batch,rows,want", [
    ("window", 43, 128, 64, (64 + 48 - 1) * 512 + 64 * 512),  # the k = 16 curve at B = 128
    ("window", 21, 100, 64, (64 + 24 - 1) * 400 + 64 * 400),  # 25 float4 groups
    ("window", 43, 200, 64, (64 + 48 - 1) * 512 + 64 * 512),  # a 128-column chunk
    ("window", 43, 3, 64, (64 + 48 - 1) * 16 + 64 * 16),  # one ragged group
    ("general", 9, 128, 64, 64 * 512),  # g only
    ("row", 43, 1, 8, 0),
])
def test_band_grad_smem(template, d, batch, rows, want):
    """K5's shared memory per block: the operand window [TR + 8 ceil(D/8)
    - 1, 4 x groups] f32 before g [TR, 4 x groups] f32."""
    assert tdia.band_grad_smem(template, d, batch, rows) == want


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 37, 100, 128, 129, 200])
def test_band_grad_plan(batch):
    """B = 1 takes the row template (one warp a row); wider batches on a
    filled layout the window template with 64-row runs within the budget,
    above 128 columns the plan of 128; gapped layouts the general one."""
    layouts = ((CURVE_OFFSETS, 21, "window"), (K8_OFFSETS, 10, "window"),
               (tdia.GAPPED_OFFSETS, 512, "general"), (tdia.spread_offsets(), 512, "general"),
               (tuple(o for o in range(-10, 11) if o != 3), 10, "general"))
    for offsets, w, template in layouts:
        plan = tdia.band_grad_plan(offsets, w, batch)
        if batch == 1:
            assert plan == tdia.BandGradPlan("row", 8)
            continue
        assert plan == tdia.BandGradPlan(template, 64)
        smem = tdia.band_grad_smem(plan.template, len(offsets), batch, plan.rows_per_block)
        assert smem <= tdia._SMEM_BUDGET
    if batch > 128:
        assert tdia.band_grad_plan(CURVE_OFFSETS, 21, batch) == tdia.band_grad_plan(
            CURVE_OFFSETS, 21, 128)
    with pytest.raises(ValueError, match="batch"):
        tdia.band_grad_plan(CURVE_OFFSETS, 21, 0)


def test_band_grad_plan_caps_the_row_run_by_the_budget():
    """The widest filled layout (W = 63, D = 127) at B = 128: the window
    [TR + 127, 128] and g [TR, 128] f32 leave room for 48 rows."""
    offsets = tuple(range(-63, 64))
    plan = tdia.band_grad_plan(offsets, 63, 128)
    assert plan == tdia.BandGradPlan("window", 48)
    assert tdia.band_grad_smem("window", 127, 128, 48) <= tdia._SMEM_BUDGET
    assert tdia.band_grad_smem("window", 127, 128, 52) > tdia._SMEM_BUDGET


def test_band_grad_bytes_at_the_curve262k_layout():
    """K5's byte bound: g and pv read once, the 128-lane band written once
    (404 MB at Npd = 263,168, B = 128, f32; 137 MB at B = 1)."""
    from manifold_gp_torch.utils import roofline

    spec = {"format": "dia", "num_padded": 263_168, "num_offsets": 43, "halfwidth": 21}
    assert roofline.band_grad_bytes(spec, 128)["total"] == 263_168 * (2 * 128 + 128) * 4
    assert roofline.band_grad_bytes(spec, 1)["total"] == 263_168 * (2 + 128) * 4
    assert roofline.band_grad_bytes(spec, 1, out_dtype_bytes=2)["output"] == 263_168 * 256
    assert roofline.matvec_flops(spec, 128) == 2 * 263_168 * 43 * 128


class _FakeLibrary:
    """The kernel library's K5 entry, recording its arguments."""

    def __init__(self):
        self.calls = []

    def dia_band_grad(self, *args):
        self.calls.append(args)
        return 0


def test_band_grad_launch_is_counted_while_tracing(monkeypatch):
    """Every K5 launch adds 1 to ``dia_band_grad_launch_count`` and, while a
    profiler records, to the traced counter ``dia.band_grad.<template>``;
    the C entry gets the layout, the band's type and the plan. Recording is
    the profiler's flag (pinned in test_torch_tracing.py), set here by hand:
    starting a profiler costs seconds."""
    from torch.autograd import profiler as autograd_profiler

    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.utils import metrics

    lib = _FakeLibrary()
    monkeypatch.setattr(cuda_spmv, "_lib", lib)
    lay, g, pv = _band_grad_case(CURVE_OFFSETS, 1100, 128, seed=1)
    _, g1, pv1 = _band_grad_case(CURVE_OFFSETS, 1100, 1, seed=1)
    metrics.reset()
    try:
        before = tdia.dia_band_grad_launch_count
        tdia._launch_band_grad(lay, g, pv, torch.float32, 0)
        assert metrics.traced()["counters"] == {}
        with monkeypatch.context() as recording:
            recording.setattr(autograd_profiler, "_is_profiler_enabled", True)
            for _ in range(3):
                tdia._launch_band_grad(lay, g, pv, torch.bfloat16, 0)
            tdia._launch_band_grad(lay, g1, pv1, torch.float32, 0)
        assert metrics.traced()["counters"] == {"dia.band_grad.window": 3,
                                                "dia.band_grad.row": 1}
        assert tdia.dia_band_grad_launch_count == before + 5
    finally:
        metrics.reset()
    (_, _, _, offs, d, w, npd, batch, stride, mode, kind, rows, stream) = lib.calls[1]
    assert list(offs) == list(CURVE_OFFSETS) and (d, w, npd, batch) == (43, 21, lay.num_padded, 128)
    assert (stride, mode, kind, rows, stream) == (tdia.BAND_WIDTH, 1, tdia._KINDS["window"], 64, 0)
    assert lib.calls[-1][7] == 1 and lib.calls[-1][10:12] == (tdia._KINDS["row"], 8)


# -- the training loss on a DIA layout --------------------------------------

RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")
INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=1.0, lengthscale=1.0)


def test_mll_loss_on_dia_matches_jax(monkeypatch):
    """The curve campaign's training configuration (DIA bands, f32, panel
    cotangents, Jacobi) at N = 1,500, k = 8, with shared probes: the twin of
    test_torch_train.py::test_mll_loss_slq_branch_matches_jax on DIA. The
    coordinates are rescaled to unit graph bandwidth, as in the campaign."""
    n = 1500
    x, t = curve_points(n, seed=0)
    y = (np.sin(3 * t) + 0.5 * np.sin(7 * t)
         + 0.1 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)
    y = (y - y.mean()) / y.std(ddof=1)
    x = x / (2.0 * float(np.sqrt(np.median(np.asarray(jgraph.build_graph(x, 8).sqdist)))))
    kw = dict(max_cholesky=0, dense_operator_max_size=0, num_probes=8, lanczos_max_iter=12,
              cg_tolerance=1e-6, cg_max_iter=400, precond_type="jacobi",
              spmv_dtype="float32", solve_cotangent="panel", use_dia=True)
    jc, tc = J.InferenceConfig(**kw), T.InferenceConfig(**kw)
    common = dict(nu=2, x=x, nearest_neighbors=8, laplacian_normalization="randomwalk")
    jk = J.RiemannMaternKernel(cfg=jc, **common)
    tk = T.RiemannMaternKernel(cfg=tc, device="cpu", **common)
    assert isinstance(jk.block_layout, jdia.DiaLayout)
    assert isinstance(tk.block_layout, tdia.DiaLayout)
    assert tk.block_layout.offsets == jk.block_layout.offsets
    jm, tm = J.RiemannGP(x, jnp.asarray(y), jk, cfg=jc), T.RiemannGP(x, y, tk, cfg=tc)

    probes = (2 * np.random.default_rng(1).integers(0, 2, (n, 8)) - 1).astype(np.float32)
    monkeypatch.setattr(jengine, "rademacher_probes", lambda key, n_, p_: jnp.asarray(probes))
    jl, jg = jax.value_and_grad(lambda p: jm.mll_loss(p, key=jax.random.PRNGKey(0)))(
        jm.init_params(**INIT))
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**INIT).items()}
    tdia.dia_launch_count = 0
    tl = tm.mll_loss(tp, probes=torch.from_numpy(probes))
    tg = torch.autograd.grad(tl, [tp[k] for k in RAW])
    assert tdia.dia_launch_count == 0
    jg = np.array([float(jg[k]) for k in RAW])
    tg = np.array([float(g) for g in tg])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=5e-3 * np.abs(jg).max())
