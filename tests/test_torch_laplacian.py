"""Port vs JAX (and the dense f64 oracle): Laplacian coefficients, the three
matvec execution paths, the Gershgorin bound and the Nystrom extension.

Tolerances: both sides are f32 with the same formulas; the scatter-adds and
products sum in different orders, so values agree to a few f32 ulps
(rtol 1e-5). Against the f64 oracle the f32 assembly error is ~1e-6
relative to the operator scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_data
from _dense_oracles import dense_graph_laplacian
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import laplacian as jlap
from manifold_gp_torch.ops import block_sparse as tbs
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import laplacian as tlap

EPS = 0.35


@pytest.fixture(scope="module")
def small_cloud():
    return _torch_data.small_cloud()


@pytest.fixture(scope="module")
def graphs(small_cloud):
    x, _ = small_cloud
    jg = jgraph.build_graph(x, 8)
    tg = tgraph.build_graph(x, 8, device="cpu")
    return jg, tg


def test_laplacian_coeffs_match_jax(graphs):
    jg, tg = graphs
    jc = jlap.laplacian_coeffs(jg, EPS)
    tc = tlap.laplacian_coeffs(tg, EPS)
    for name in jc._fields:
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
            rtol=1e-5, atol=1e-7, err_msg=name,
        )


def test_laplacian_dense_matches_oracle(graphs):
    jg, tg = graphs
    tc = tlap.laplacian_coeffs(tg, EPS)
    n = tg.num_nodes
    lap, *_ = dense_graph_laplacian(
        tg.rows.numpy(), tg.cols.numpy(), tg.sqdist.numpy().astype(np.float64), EPS, n,
        normalization="symmetric",
    )
    got = tlap.laplacian_dense(tg, tc).numpy()
    np.testing.assert_allclose(got, lap, atol=2e-5 * np.abs(lap).max())


@pytest.mark.parametrize("path", ["dense", "block", "ell"])
@pytest.mark.parametrize("normalization", ["symmetric", "randomwalk"])
@pytest.mark.parametrize("transposed", [False, True])
def test_laplacian_matvec_matches_jax_and_oracle(graphs, path, normalization, transposed):
    jg, tg = graphs
    jc = jlap.laplacian_coeffs(jg, EPS)
    tc = tlap.laplacian_coeffs(tg, EPS)
    n = tg.num_nodes
    v = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    dense = block = None
    if path == "dense":
        dense = tlap.laplacian_dense(tg, tc)
    elif path == "block":
        layout = tbs.build_block_layout(tg)
        block = (layout, tbs.assemble(layout, tc.diag, tc.triu))
    got = tlap.laplacian_matvec(
        tg, tc, torch.from_numpy(v), normalization, transposed, dense=dense, block=block
    ).numpy()
    want = np.asarray(jlap.laplacian_matvec(
        jg, jc, jnp.asarray(v), normalization, transposed,
        dense=jlap.laplacian_dense(jg, jc),
    ))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)
    lap, *_ = dense_graph_laplacian(
        tg.rows.numpy(), tg.cols.numpy(), tg.sqdist.numpy().astype(np.float64), EPS, n,
        normalization=normalization,
    )
    oracle = (lap.T if transposed else lap) @ v.astype(np.float64)
    np.testing.assert_allclose(got, oracle, atol=2e-5 * scale)


@pytest.mark.parametrize("transposed", [False, True])
def test_laplacian_matvec_vector_block_paths(graphs, transposed):
    _, tg = graphs
    tc = tlap.laplacian_coeffs(tg, EPS)
    layout = tbs.build_block_layout(tg)
    block = (layout, tbs.assemble(layout, tc.diag, tc.triu))
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(tg.num_nodes).astype(np.float32))
    got = tlap.laplacian_matvec(tg, tc, v, "randomwalk", transposed, block=block)
    want = tlap.laplacian_matvec(tg, tc, v, "randomwalk", transposed,
                                 dense=tlap.laplacian_dense(tg, tc))
    assert got.shape == (tg.num_nodes,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * float(want.abs().max()))


def test_adjacency_matvec_coo_matches_jax(graphs):
    """The COO oracle (two scatter-adds over the triu list) against JAX's on
    the same graph (1e-6 of the largest entry: f32 sums in another order),
    and the ELL gather path against it."""
    jg, tg = graphs
    jc = jlap.laplacian_coeffs(jg, EPS)
    tc = tlap.laplacian_coeffs(tg, EPS)
    v = np.random.default_rng(6).standard_normal((tg.num_nodes, 4)).astype(np.float32)
    got = tlap.adjacency_matvec_coo(tg, tc.triu, torch.from_numpy(v)).numpy()
    want = np.asarray(jlap.adjacency_matvec_coo(jg, jc.triu, jnp.asarray(v)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    ell = tlap.adjacency_matvec_ell(tg, tc.triu, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(ell, got, rtol=0, atol=1e-6 * scale)


def test_gershgorin_bound_matches_jax(graphs):
    jg, tg = graphs
    want = float(jlap.gershgorin_bound(jg, jlap.laplacian_coeffs(jg, EPS)))
    got = float(tlap.gershgorin_bound(tg, tlap.laplacian_coeffs(tg, EPS)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("normalization", ["symmetric", "randomwalk"])
def test_out_of_sample_matches_jax(graphs, small_cloud, normalization):
    jg, tg = graphs
    x, _ = small_cloud
    rng = np.random.default_rng(9)
    eigvec = rng.standard_normal((x.shape[0], 6)).astype(np.float32)
    xq = (x[:20] + 0.02 * rng.standard_normal((20, 2))).astype(np.float32)
    d = ((xq[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1)[:, :8]
    sqd = np.take_along_axis(d, idx, axis=1).astype(np.float32)
    want = np.asarray(jlap.out_of_sample(
        jg, jlap.laplacian_coeffs(jg, EPS), jnp.asarray(eigvec), jnp.asarray(sqd),
        jnp.asarray(idx), EPS, normalization,
    ))
    got = tlap.out_of_sample(
        tg, tlap.laplacian_coeffs(tg, EPS), torch.from_numpy(eigvec),
        torch.from_numpy(sqd), torch.from_numpy(idx), EPS, normalization,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
