"""Port vs JAX: the panel-cotangent kernel K3 and the two differentiable
block matvecs built on it.

On the CPU the port runs K3's plain version (``bwd_blocks_plain``); the JAX
side runs its Pallas kernels in interpret mode, as tests/test_pallas_spmv.py
does, with the batch padded to 128 as its caller pads it. f32 results differ
by sum order only (a few ulps of the output scale); bf16 results may differ
by one bf16 rounding step (2^-8 relative) where the f32 sums straddle a
rounding boundary.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_tpu.ops import pallas_spmv as jps
from manifold_gp_torch.ops import block_sparse as tbs
from manifold_gp_torch.ops import cuda_spmv as tcs
from manifold_gp_torch.ops import graph as tgraph

JDT = {"float32": None, "bfloat16": jnp.bfloat16, "float32x3": "float32x3"}
TDT = {"float32": None, "bfloat16": torch.bfloat16, "float32x3": "float32x3"}
F32_TOL = 3e-6  # of the output scale: f32 sum order
BF16_TOL = 2.0 ** -7  # of the output scale: one bf16 rounding step


def _clustered_cloud(n=600, seed=1337):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    return centers[rng.integers(0, 4, n)] + 0.2 * rng.standard_normal((n, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    x = _clustered_cloud()
    jg = jgraph.build_graph(x, 8)
    jc = jlap.laplacian_coeffs(jg, 0.5)
    jl = jbs.build_block_layout(jg)
    tl = tbs.build_block_layout(tgraph.build_graph(x, 8, device="cpu"))
    return jl, tl, np.array(jc.diag), np.array(jc.triu)


def _vectors(layout, batch, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((layout.num_nodes, batch)).astype(np.float32)
    pv = np.array(jbs.permute_in(layout, jnp.asarray(v)))
    g = rng.standard_normal((layout.num_padded, batch)).astype(np.float32)
    return pv, g


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 37, 128])
def test_plain_bwd_blocks_matches_pallas_k3(problem, out_dtype, batch):
    jl, tl, _, _ = problem
    pv, g = _vectors(jl, batch, seed=batch)
    pad = -batch % 128  # the TPU kernel needs a 128-multiple batch
    want = jps.block_bwd_blocks_pallas_streaming(
        jl, jnp.pad(jnp.asarray(g), ((0, 0), (0, pad))),
        jnp.pad(jnp.asarray(pv), ((0, 0), (0, pad))),
        out_dtype=jnp.float32 if out_dtype == "float32" else jnp.bfloat16, interpret=True,
    )
    tdt = torch.float32 if out_dtype == "float32" else torch.bfloat16
    tcs.bwd_launch_count = 0
    bc = tl.block_col.reshape(-1)
    got_raw = tcs.bwd_blocks_call(bc, torch.from_numpy(g), torch.from_numpy(pv),
                                  s_max=tl.max_blocks, out_dtype=tdt)
    got_layout = tcs.block_bwd_blocks(tl, torch.from_numpy(g), torch.from_numpy(pv), out_dtype=tdt)
    assert tcs.bwd_launch_count == 0  # CPU tensors: the plain version, no launch
    assert got_raw.dtype == tdt and tuple(got_raw.shape) == tuple(want.shape)
    tol = F32_TOL if out_dtype == "float32" else BF16_TOL
    for got in (got_raw, got_layout):
        _assert_close(got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("batch,batch_class", [
    (1, 16), (8, 16), (15, 16), (16, 16), (17, 32), (32, 32), (33, 64), (48, 64), (64, 64),
    (65, 32), (128, 32), (129, 32), (200, 32)])
def test_bwd_batch_class_choice(batch, batch_class):
    """K3's template: the narrowest of 16 / 32 / 64 columns that holds the
    batch (g then stays in shared memory for the whole row block); wider
    batches run in 32-column chunks."""
    assert tcs._bwd_batch_class(batch) == batch_class


@pytest.mark.parametrize("batch", [0, -3])
def test_bwd_batch_class_refuses_empty_batches(batch):
    with pytest.raises(ValueError, match="positive"):
        tcs._bwd_batch_class(batch)


def test_bwd_blocks_writes_padding_slots_like_the_tpu_kernel(problem):
    # slots assemble never fills carry block_col = 0 and receive g[r] @ pv[0:128]^T
    jl, tl, _, _ = problem
    pv, g = _vectors(jl, 3, seed=9)
    out = tcs.block_bwd_blocks(tl, torch.from_numpy(g), torch.from_numpy(pv))
    s = tl.max_blocks - 1
    # a row block other than 0 whose last slot is padding (block 0 is not
    # among its neighbours' last slots: ids are sorted within a row block)
    r = int(torch.nonzero(tl.block_col[1:, s] == 0)[0]) + 1
    want = g[r * 128:(r + 1) * 128] @ pv[:128].T
    np.testing.assert_allclose(out[r, :, s * 128:].numpy(), want, atol=1e-5)


def test_bwd_blocks_rejects_bad_inputs(problem):
    _, tl, _, _ = problem
    bc = tl.block_col.reshape(-1)
    g = torch.zeros(tl.num_padded, 4)
    pv = torch.zeros(tl.num_padded, 4)
    kw = dict(s_max=tl.max_blocks)
    with pytest.raises(ValueError, match="int32"):
        tcs.bwd_blocks_call(bc.long(), g, pv, **kw)
    with pytest.raises(ValueError, match="float32"):
        tcs.bwd_blocks_call(bc, g.double(), pv, **kw)
    with pytest.raises(ValueError, match="batch"):
        tcs.bwd_blocks_call(bc, g[:, :3], pv, **kw)
    with pytest.raises(TypeError, match="out_dtype"):
        tcs.bwd_blocks_call(bc, g, pv, out_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="empty"):
        tcs.bwd_blocks_call(bc, g[:, :0], pv[:, :0], **kw)
    with pytest.raises(ValueError, match="outside"):  # operand too short for the ids
        tcs.bwd_blocks_call(bc, g, pv[:-128], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.bwd_blocks_cuda(bc, g, pv, **kw)
    with pytest.raises(ValueError, match="rows"):
        tcs.block_bwd_blocks(tl, g[:-128], pv)


def _panels(jl, tl, diag, triu, dtype):
    jb = jbs.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), dtype=JDT[dtype])
    tb = tbs.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu), dtype=TDT[dtype])
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32x3"])
@pytest.mark.parametrize("batch", [5, 128])
def test_matvec_ad_gradients_match_jax(problem, dtype, batch):
    """make_matvec_ad: forward, bar_blocks (K3) and bar_pv (the forward
    kernel on g) against JAX's custom VJP, with its size budget patched to 0
    so that it takes the K3 path."""
    jl, tl, diag, triu = problem
    jb, tb = _panels(jl, tl, diag, triu, dtype)
    pv, g = _vectors(jl, batch, seed=batch + 1)
    with unittest.mock.patch.object(jps, "_OPERAND_VMEM_BUDGET", 0):
        mv = jps.make_matvec_ad(jl, interpret=True)
        jout, vjp = jax.vjp(mv, jb, jnp.asarray(pv))
        jbar_b, jbar_pv = vjp(jnp.asarray(g))
    tb = tb.clone().requires_grad_(True)
    tpv = torch.from_numpy(pv).requires_grad_(True)
    tout = tcs.make_matvec_ad(tl)(tb, tpv)
    tbar_b, tbar_pv = torch.autograd.grad(tout, (tb, tpv), torch.from_numpy(g))
    # forward and bar_pv are the same product: x3 merges vs three bf16
    # products differ by ~2^-15 (see test_torch_block_sparse)
    fwd_tol = 2e-4 if dtype == "float32x3" else F32_TOL
    _assert_close(tout.detach().numpy(), jout, fwd_tol)
    _assert_close(tbar_pv.numpy(), jbar_pv, fwd_tol)
    assert tbar_b.dtype == tb.dtype and tuple(tbar_b.shape) == tuple(jbar_b.shape)
    _assert_close(tbar_b.to(torch.float32).numpy(), np.asarray(jbar_b.astype(jnp.float32)),
                  F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32x3":  # both halves receive the same cotangent
        assert torch.equal(tbar_b[0], tbar_b[1])


@pytest.mark.parametrize("batch", [5, 128])
def test_matvec_ad_bf16_panel_cotangent_matches_jax_einsum_branch(problem, batch):
    """bf16 panels: bar_blocks against JAX's custom VJP at its own size
    budget, where it takes the bf16 einsum branch (g and the gathered
    operand rounded to bf16, f32 sums, one rounding) that the panel-space
    training pins run through. The two agree but for a few elements where
    f32 sum order straddles a bf16 rounding boundary; a product that skips
    the rounding of g, still within BF16_TOL of the largest value, misses
    in over a third of the elements, so the mean error tells them apart."""
    jl, tl, diag, triu = problem
    jb, tb = _panels(jl, tl, diag, triu, "bfloat16")
    pv, g = _vectors(jl, batch, seed=batch + 1)
    assert pv.shape[0] * 128 * 4 <= jps._OPERAND_VMEM_BUDGET  # the einsum branch
    _, vjp = jax.vjp(jps.make_matvec_ad(jl, interpret=True), jb, jnp.asarray(pv))
    want = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    tb = tb.clone().requires_grad_(True)
    tout = tcs.make_matvec_ad(tl)(tb, torch.from_numpy(pv))
    (got,) = torch.autograd.grad(tout, (tb,), torch.from_numpy(g))

    def mean_rel_err(x):
        return np.abs(np.asarray(x, np.float32) - want).sum() / np.abs(want).sum()

    _assert_close(got.to(torch.float32).numpy(), want, BF16_TOL)
    assert mean_rel_err(got.to(torch.float32).numpy()) <= 1e-6
    bc = tl.block_col.long()
    nrb, s_max = tl.num_row_blocks, tl.max_blocks
    rounded_pv = torch.from_numpy(pv).to(torch.bfloat16).to(torch.float32)
    gathered = rounded_pv.reshape(nrb, 128, batch)[bc].reshape(nrb, s_max * 128, batch)
    unrounded_g = torch.bmm(torch.from_numpy(g).reshape(nrb, 128, batch), gathered.mT)
    assert mean_rel_err(unrounded_g.to(torch.bfloat16).to(torch.float32).numpy()) > 1e-4


def test_matvec_ad_skips_the_cotangents_nobody_asks_for(problem):
    jl, tl, diag, triu = problem
    _, tb = _panels(jl, tl, diag, triu, "float32")
    pv, g = _vectors(jl, 4, seed=2)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tcs._run_block_kernel, tcs.block_bwd_blocks

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    with unittest.mock.patch.object(tcs, "_run_block_kernel", count_fwd), \
            unittest.mock.patch.object(tcs, "block_bwd_blocks", count_bwd):
        tpv = torch.from_numpy(pv).requires_grad_(True)
        out = tcs.make_matvec_ad(tl)(tb, tpv)  # panels need no gradient
        torch.autograd.grad(out, tpv, torch.from_numpy(g))
        assert calls == {"fwd": 2, "bwd": 0}
        tb2 = tb.clone().requires_grad_(True)
        out = tcs.make_matvec_ad(tl)(tb2, torch.from_numpy(pv))  # operand needs none
        torch.autograd.grad(out, tb2, torch.from_numpy(g))
        assert calls == {"fwd": 3, "bwd": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32x3"])
def test_matvec_edge_ad_gradients_match_jax(problem, dtype):
    """make_matvec_edge_ad: (bar_diag, bar_triu, bar_pv) against JAX's, both
    K3 paths; the panels get no gradient."""
    jl, tl, diag, triu = problem
    jb, tb = _panels(jl, tl, diag, triu, dtype)
    pv, g = _vectors(jl, 37, seed=11)
    with unittest.mock.patch.object(jps, "_OPERAND_VMEM_BUDGET", 0):
        mv = jps.make_matvec_edge_ad(jl, interpret=True, use_pallas=True)
        jout, vjp = jax.vjp(mv, jb, jnp.asarray(diag), jnp.asarray(triu), jnp.asarray(pv))
        _, jbar_d, jbar_t, jbar_pv = vjp(jnp.asarray(g))
    td = torch.from_numpy(diag).requires_grad_(True)
    tt = torch.from_numpy(triu).requires_grad_(True)
    tpv = torch.from_numpy(pv).requires_grad_(True)
    tbq = tb.clone().requires_grad_(True)
    tout = tcs.make_matvec_edge_ad(tl)(tbq, td, tt, tpv)
    tbar_q, tbar_d, tbar_t, tbar_pv = torch.autograd.grad(
        tout, (tbq, td, tt, tpv), torch.from_numpy(g), allow_unused=True)
    assert tbar_q is None
    fwd_tol = 2e-4 if dtype == "float32x3" else F32_TOL
    _assert_close(tout.detach().numpy(), jout, fwd_tol)
    _assert_close(tbar_pv.numpy(), jbar_pv, fwd_tol)
    _assert_close(tbar_d.numpy(), jbar_d, F32_TOL)  # always f32, whatever the panels
    _assert_close(tbar_t.numpy(), jbar_t, F32_TOL)


def test_edge_ad_matches_autograd_through_assemble(problem):
    """Twin of tests/test_edge_cotangent.py: the edge-space backward equals
    plain autograd through assemble + the panel-space matvec, to f32
    roundoff."""
    jl, tl, diag, triu = problem
    pv, g = _vectors(jl, 6, seed=5)
    tpv, tg = torch.from_numpy(pv), torch.from_numpy(g)

    def grads(edge):
        d = torch.from_numpy(diag).requires_grad_(True)
        t = torch.from_numpy(triu).requires_grad_(True)
        p = tpv.clone().requires_grad_(True)
        blocks = tbs.assemble(tl, d, t)
        if edge:
            out = tcs.make_matvec_edge_ad(tl)(blocks.detach(), d, t, p)
        else:
            out = tcs.make_matvec_ad(tl)(blocks, p)
        return torch.autograd.grad(out, (d, t, p), tg)

    for e, p in zip(grads(True), grads(False)):
        _assert_close(e.numpy(), p.numpy(), 1e-6)
