"""Port vs JAX: block-ELL layout, panel assembly, and the plain version of
the CUDA SpMV kernel against JAX's own Pallas kernels K1/K2 (run in
interpret mode, as tests/test_pallas_spmv.py runs them).

Layouts and assembled panels must be IDENTICAL (same RCM order, same slot
order, same scatter values). Matvecs agree to f32 sum-order rounding: the
products are exact in f32 for every panel type (bf16 x bf16 products fit in
f32's mantissa), so the tolerance is a few ulps of the output scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_tpu.ops import pallas_spmv as jps
from manifold_gp_torch.ops import block_sparse as tbs
from manifold_gp_torch.ops import cuda_spmv as tcs
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import sparse_formats as tsf


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
    tg = tgraph.build_graph(x, 8, device="cpu")
    tl = tbs.build_block_layout(tg)
    diag, triu = np.array(jc.diag), np.array(jc.triu)
    return jl, tl, diag, triu


def _assert_layouts_equal(jl, tl):
    for name in ("num_nodes", "num_padded", "num_row_blocks", "max_blocks"):
        assert getattr(tl, name) == getattr(jl, name), name
    for name in ("perm", "unperm", "block_col", "edge_flat", "diag_flat"):
        np.testing.assert_array_equal(
            getattr(tl, name).numpy(), np.asarray(getattr(jl, name)), err_msg=name
        )
    assert tl.block_col.dtype == torch.int32


def test_layout_identical_clustered(problem):
    jl, tl, _, _ = problem
    _assert_layouts_equal(jl, tl)


def test_layout_identical_torus_2k():
    x, _, _ = torus_points(2048, seed=5)
    _assert_layouts_equal(
        jbs.build_block_layout(jgraph.build_graph(x, 16)),
        tbs.build_block_layout(tgraph.build_graph(x, 16, device="cpu")),
    )


def test_layout_cap_returns_none(problem):
    x = _clustered_cloud()
    assert tbs.build_block_layout(tgraph.build_graph(x, 8, device="cpu"), max_blocks_cap=1) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32x3"])
def test_assemble_identical(problem, dtype):
    jl, tl, diag, triu = problem
    jdt = {"float32": None, "bfloat16": jnp.bfloat16, "float32x3": "float32x3"}[dtype]
    tdt = {"float32": None, "bfloat16": torch.bfloat16, "float32x3": "float32x3"}[dtype]
    want = np.asarray(jbs.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), dtype=jdt))
    got = tbs.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu), dtype=tdt)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))


def _panels(jl, tl, diag, triu, dtype):
    jdt = {"float32": None, "bfloat16": jnp.bfloat16, "float32x3": "float32x3"}[dtype]
    tdt = {"float32": None, "bfloat16": torch.bfloat16, "float32x3": "float32x3"}[dtype]
    jb = jbs.assemble(jl, jnp.asarray(diag), jnp.asarray(triu), dtype=jdt)
    tb = tbs.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu), dtype=tdt)
    return jb, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32x3"])
@pytest.mark.parametrize("batch", [1, 8, 37, 48, 128, 129])
def test_plain_kernel_matches_pallas_k1_k2(problem, dtype, batch):
    jl, tl, diag, triu = problem
    jb, tb = _panels(jl, tl, diag, triu, dtype)
    rng = np.random.default_rng(batch)
    v = rng.standard_normal((jl.num_nodes, batch)).astype(np.float32)
    pv = np.array(jbs.permute_in(jl, jnp.asarray(v)))
    bc = jl.block_col.reshape(-1)
    k1 = np.asarray(jps.resident_matvec_call(bc, jb, jnp.asarray(pv),
                                             s_max=jl.max_blocks, interpret=True))
    pad = -batch % 128  # the TPU streaming kernel needs a 128-multiple batch
    k2 = np.asarray(jps.stream_matvec_call(
        bc, jb, jnp.pad(jnp.asarray(pv), ((0, 0), (0, pad))),
        s_max=jl.max_blocks, interpret=True,
    ))[:, :batch]
    tbc = tl.block_col.reshape(-1)
    tcs.launch_count = 0
    t1 = tcs.resident_matvec_call(tbc, tb, torch.from_numpy(pv), s_max=tl.max_blocks)
    t2 = tcs.stream_matvec_call(tbc, tb, torch.from_numpy(pv), s_max=tl.max_blocks)
    assert tcs.launch_count == 0  # CPU tensors: the plain version, no launch
    scale = np.abs(k1).max()
    for got in (t1.numpy(), t2.numpy()):
        np.testing.assert_allclose(got, k1, atol=2e-6 * scale)
        np.testing.assert_allclose(got, k2, atol=2e-6 * scale)


@pytest.mark.parametrize("batch, tile", [(1, 8), (8, 8), (9, 16), (48, 64), (125, 128),
                                         (129, 128), (200, 128), (0, None)])
def test_batch_tile_choice(batch, tile):
    """The forward kernel's batch tile: the smallest template width that
    covers min(B, 128); wider batches take several 128-wide tiles."""
    if tile is None:
        with pytest.raises(ValueError, match="positive"):
            tcs._batch_tile(batch)
    else:
        assert tcs._batch_tile(batch) == tile


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float32x3"])
def test_matvec_permuted_and_dispatch_match_jax(problem, dtype):
    jl, tl, diag, triu = problem
    jb, tb = _panels(jl, tl, diag, triu, dtype)
    v = np.random.default_rng(3).standard_normal((jl.num_nodes, 5)).astype(np.float32)
    want = np.asarray(jbs.matvec(jl, jb, jnp.asarray(v)))
    scale = np.abs(want).max()
    # JAX's einsum path merges x3 panels to f32; the port spells out the
    # three bf16 products, as the kernels do: ~2^-15 relative apart
    tol = 2e-4 if dtype == "float32x3" else 2e-6
    tv = torch.from_numpy(v)
    permuted = tbs.permute_out(tl, tcs.block_matvec(tl, tb, tbs.permute_in(tl, tv)))
    for got in (permuted, tcs.matvec(tl, tb, tv), tsf.matvec(tl, tb, tv)):
        np.testing.assert_allclose(got.numpy(), want, atol=tol * scale)


def test_split_merge_bf16x3_match_jax():
    x = np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(jps.split_bf16x3(jnp.asarray(x))).astype(np.float32)
    got = tcs.split_bf16x3(torch.from_numpy(x))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        tcs.merge_bf16x3(got).numpy(), np.asarray(jps.merge_bf16x3(jps.split_bf16x3(jnp.asarray(x))))
    )


def test_wrapper_rejects_bad_inputs(problem):
    _, tl, diag, triu = problem
    tb = tbs.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu))
    pv = torch.zeros(tl.num_padded, 4)
    bc = tl.block_col.reshape(-1)
    with pytest.raises(ValueError, match="int32"):
        tcs.resident_matvec_call(bc.long(), tb, pv, s_max=tl.max_blocks)
    with pytest.raises(ValueError, match="float32"):
        tcs.resident_matvec_call(bc, tb, pv.double(), s_max=tl.max_blocks)
    with pytest.raises(TypeError):
        tcs.resident_matvec_call(bc, tb.half(), pv, s_max=tl.max_blocks)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.block_matvec_cuda(bc, tb, pv, s_max=tl.max_blocks)


def test_wrapper_rejects_out_of_range_and_empty(problem):
    # The kernel reads the operand at the block_col ids unchecked, and its C
    # entry launches nothing for an empty problem: both must raise up front.
    _, tl, diag, triu = problem
    tb = tbs.assemble(tl, torch.from_numpy(diag), torch.from_numpy(triu))
    bc = tl.block_col.reshape(-1)
    nrb = tl.num_row_blocks
    with pytest.raises(ValueError, match="outside"):  # operand too short for the ids
        tcs.stream_matvec_call(bc, tb, torch.zeros((nrb - 1) * 128, 4), s_max=tl.max_blocks)
    bad = bc.clone()
    bad[-1] = -1
    with pytest.raises(ValueError, match="outside"):
        tcs.resident_matvec_call(bad, tb, torch.zeros(tl.num_padded, 4), s_max=tl.max_blocks)
    with pytest.raises(ValueError, match="empty"):
        tcs.resident_matvec_call(bc, tb, torch.zeros(tl.num_padded, 0), s_max=tl.max_blocks)
    with pytest.raises(ValueError, match="rows"):  # layout path: operand height
        tcs.block_matvec(tl, tb, torch.zeros(tl.num_padded + 128, 4))
    stale = tl.block_col.clone()
    stale[0, 0] = nrb
    with pytest.raises(ValueError, match="outside"):  # checked once, at layout build
        dataclasses.replace(tl, block_col=stale)


def test_build_layout_picks_the_layout_jax_picks():
    """DIA bands for a banded graph (a ring; jittered: equally spaced points
    tie their two neighbour distances), with arrays equal to JAX's;
    block-ELL panels for the same graph with use_dia=False, and for a torus
    sample, whose RCM band is too wide for DIA."""
    from manifold_gp_tpu.ops import sparse_formats as jsf
    from manifold_gp_torch.ops.dia import DiaLayout

    t = np.linspace(0, 2 * np.pi, 1500, endpoint=False)
    x = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    x += 1e-3 * np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    jg = jgraph.build_graph(x, 4)
    tg = tgraph.build_graph(x, 4, device="cpu")
    jl, tl = jsf.build_layout(jg), tsf.build_layout(tg)
    assert type(jl).__name__ == "DiaLayout" and isinstance(tl, DiaLayout)
    assert tl.offsets == jl.offsets and tl.num_padded == jl.num_padded
    for name in ("perm", "unperm", "edge_flat", "diag_flat"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)))
    _assert_layouts_equal(jsf.build_layout(jg, use_dia=False), tsf.build_layout(tg, use_dia=False))
    xt, _, _ = torus_points(3000, seed=2)
    jlt = jsf.build_layout(jgraph.build_graph(xt, 16))
    tlt = tsf.build_layout(tgraph.build_graph(xt, 16, device="cpu"))
    assert type(jlt).__name__ == "BlockLayout" and isinstance(tlt, tbs.BlockLayout)
    _assert_layouts_equal(jlt, tlt)
