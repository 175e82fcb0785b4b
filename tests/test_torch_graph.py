"""Port vs JAX: exact kNN search and the symmetric kNN graph build.

Edge lists, ELL tables and edge values must be EQUAL to the JAX builder's:
the coalesce, orientation and ELL code is the same host numpy, edge values
are recomputed by the same coordinate differencing, and neighbour choice is
exact (ties between distinct float distances do not occur on these
random clouds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_data
from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops import graph as jgraph
from manifold_gp_tpu.ops import knn as jknn
from manifold_gp_torch.ops import graph as tgraph
from manifold_gp_torch.ops import knn as tknn


@pytest.fixture(scope="module")
def small_cloud():
    return _torch_data.small_cloud()


def _assert_graphs_equal(jg, tg):
    assert tg.num_nodes == jg.num_nodes and tg.max_degree == jg.max_degree
    for name in ("rows", "cols", "sqdist", "mask", "ell_edge", "ell_col", "ell_mask"):
        np.testing.assert_array_equal(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name
        )


@pytest.mark.parametrize("k", [2, 6, 11])
def test_build_graph_matches_jax_small_cloud(small_cloud, k):
    x, _ = small_cloud
    _assert_graphs_equal(jgraph.build_graph(x, k), tgraph.build_graph(x, k, device="cpu"))


def test_build_graph_matches_jax_torus_2k():
    x, _, _ = torus_points(2048, seed=3)
    _assert_graphs_equal(jgraph.build_graph(x, 16), tgraph.build_graph(x, 16, device="cpu"))


@pytest.mark.parametrize("self_query", [True, False])
def test_knn_search_matches_jax(self_query):
    rng = np.random.default_rng(7)
    # an offset cloud exercises the global centering
    db = (rng.standard_normal((700, 5)) + 30.0).astype(np.float32)
    q = db if self_query else (rng.standard_normal((90, 5)) + 30.0).astype(np.float32)
    jd, ji = jknn.knn_search(jnp.asarray(db), jnp.asarray(q), 9, self_query=self_query)
    td, ti = tknn.knn_search(torch.from_numpy(db), torch.from_numpy(q), 9,
                             self_query=self_query, block_size=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # both stages recompute exact f32 differences; only the sum order of
    # the D=5 squares may differ
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    if self_query:
        np.testing.assert_array_equal(ti[:, 0].numpy(), np.arange(700))


def test_nearest_neighbors_search_and_graph(small_cloud):
    x, _ = small_cloud
    nn = tknn.NearestNeighbors(torch.from_numpy(x))
    d, i = nn.search(nn.x, 4)  # identity -> self_query
    np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(x.shape[0]))
    _assert_graphs_equal(jknn.NearestNeighbors(x).graph(5), nn.graph(5))


def test_coalesce_mean_matches_jax():
    rng = np.random.default_rng(11)
    r = rng.integers(0, 40, 500)
    c = rng.integers(0, 40, 500)
    v = rng.random(500).astype(np.float32)
    for a, b in zip(jgraph.coalesce_mean(r, c, v, 40), tgraph.coalesce_mean(r, c, v, 40)):
        np.testing.assert_array_equal(a, b)


def test_graph_from_edges_rejects_bad_edge_lists():
    with pytest.raises(ValueError, match="self-loop"):
        tgraph.graph_from_edges([0, 1], [1, 1], [1.0, 1.0], 3)
    with pytest.raises(ValueError, match="duplicate"):
        tgraph.graph_from_edges([0, 0], [1, 1], [1.0, 1.0], 3)


def test_unported_search_backends_raise(small_cloud):
    """Every JAX search backend is ported ("device", "host", "ivf"; their
    graphs are held in ``test_torch_ivf.py``): an unknown one raises, the
    IVF index answers."""
    x, _ = small_cloud
    with pytest.raises(ValueError, match="knn_backend"):
        tgraph.build_graph(x, 5, knn_backend="faiss", device="cpu")
    nn = tknn.NearestNeighbors(x, use_ivf=True)
    sqd, idx = nn.search(nn.x, 5)
    assert idx.shape == (x.shape[0], 5) and (idx[:, 0] == torch.arange(x.shape[0])).all()
