"""Port vs JAX: the inverted-file (IVF) search of ``ops/knn.py`` and the
"host" / "ivf" backends of ``ops/graph.py::build_graph``. k-means from the
same start rows gives JAX's centroids and assignment; the search over one
index gives JAX's neighbours; skewed data keeps the padded list width
bounded (twin of ``tests/test_regressions.py::
test_ivf_bounded_list_width_on_skewed_data``). Two reference-side faults
the port does not copy are shown against JAX: padding slots as query row
0's neighbours in the IVF re-rank, and the host search's unpinned
self-match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from manifold_gp_tpu.ops import knn as jknn
from manifold_gp_tpu.ops.graph import build_graph as j_build_graph
from manifold_gp_torch.ops import knn as tknn
from manifold_gp_torch.ops.graph import build_graph, pin_self_match
from manifold_gp_torch.utils import native


def _clustered(n=2000, d=8, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, d)).astype(np.float32) * 3
    return centers[rng.integers(0, 12, n)] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)


def _jax_init(n, num_clusters, seed=0):
    """The start rows JAX's ``kmeans`` draws for ``seed``."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (num_clusters,),
                                        replace=False))


def test_kmeans_matches_jax_from_the_same_start():
    x = _clustered()
    jc, ja = jknn.kmeans(jnp.asarray(x), num_clusters=16, iters=10, seed=3)
    tc, ta = tknn.kmeans(torch.from_numpy(x), 16, iters=10, init_idx=_jax_init(len(x), 16, 3))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    # an empty cluster keeps its centroid: a duplicated start row loses every
    # tie to the lower centroid id in the first assignment
    init = _jax_init(len(x), 16, 3).copy()
    init[1] = init[0]
    tc2, _ = tknn.kmeans(torch.from_numpy(x), 16, iters=1, init_idx=init)
    np.testing.assert_array_equal(tc2[1].numpy(), x[init[1]])
    assert not torch.equal(tc2[0], tc2[1])


def test_ivf_search_matches_jax_on_one_index():
    x = _clustered()
    jindex = jknn.ivf_build(jnp.asarray(x), nlist=16, kmeans_iters=5)
    tindex = tknn.IVFIndex(
        centroids=torch.tensor(np.asarray(jindex.centroids)),
        lists=torch.tensor(np.asarray(jindex.lists).astype(np.int64)),
        list_mask=torch.tensor(np.asarray(jindex.list_mask)),
        database=torch.from_numpy(x))
    # the port's own build from JAX's start rows packs the same lists
    built = tknn.ivf_build(torch.from_numpy(x), nlist=16, kmeans_iters=5,
                           init_idx=_jax_init(len(x), 16))
    np.testing.assert_array_equal(built.lists.numpy(), np.asarray(jindex.lists))
    np.testing.assert_array_equal(built.list_mask.numpy(), np.asarray(jindex.list_mask))
    for self_query, q in ((True, x), (False, x[:300] + 0.1)):
        jd, ji = jknn.ivf_search(jindex, jnp.asarray(q), 9, nprobe=3, self_query=self_query,
                                 queries_per_dispatch=700)
        td, ti = tknn.ivf_search(tindex, torch.from_numpy(q), 9, nprobe=3,
                                 self_query=self_query, queries_per_dispatch=700)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), self_query
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    assert (tknn.ivf_search(tindex, torch.from_numpy(x), 9, nprobe=3, self_query=True)[1][:, 0]
            == torch.arange(len(x))).all()


def test_ivf_search_keeps_padding_out_of_row_0():
    """Where the lists probed for query row 0 hold fewer points than the
    re-rank's 256 candidates, padding slots (id 0) reach the re-rank: JAX's
    search pins them as row 0's self-match and returns id 0 for every
    neighbour (its ``build_graph`` then fails on self-loops); the port's
    search gives them id -1 and row 0 its true neighbours. Every other row
    equals JAX's on the same index."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 2 * np.pi, 1500))
    x = (np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], 1)
         + 0.01 * rng.standard_normal((1500, 3))).astype(np.float32)
    index = tknn.ivf_build(torch.from_numpy(x), nlist=32)
    jindex = jknn.IVFIndex(jnp.asarray(index.centroids.numpy()),
                           jnp.asarray(index.lists.numpy().astype(np.int32)),
                           jnp.asarray(index.list_mask.numpy()), jnp.asarray(x))
    _, ji = jknn.ivf_search(jindex, jnp.asarray(x), 8, nprobe=8, self_query=True)
    td, ti = tknn.ivf_search(index, torch.from_numpy(x), 8, nprobe=8, self_query=True)
    assert (np.asarray(ji)[0] == 0).all()  # the reference's alias
    np.testing.assert_array_equal(ti.numpy()[1:], np.asarray(ji)[1:])
    _, exact = tknn.knn_search(torch.from_numpy(x), torch.from_numpy(x[:1]), 8, self_query=True)
    np.testing.assert_array_equal(ti[0].numpy(), exact[0].numpy())


def test_ivf_bounded_list_width_on_skewed_data():
    """One dense cluster and a sparse halo: the padded posting-list width
    stays bounded by the re-split cap instead of tracking the biggest
    cluster."""
    rng = np.random.default_rng(1337)
    dense = 0.01 * rng.standard_normal((1600, 8)).astype(np.float32)
    halo = rng.standard_normal((400, 8)).astype(np.float32) + 5.0
    x = np.concatenate([dense, halo]).astype(np.float32)
    index = tknn.ivf_build(torch.from_numpy(x), nlist=16)
    n, nlist = x.shape[0], index.nlist
    cap = max(int(4.0 * n / 16), 8)  # cap computed from the requested nlist
    assert index.lists.shape[1] <= cap, (index.lists.shape, cap)
    assert nlist >= 16  # splitting only ever adds centroids
    ids = index.lists.numpy()[index.list_mask.numpy() > 0]
    assert np.array_equal(np.sort(ids), np.arange(n))
    sq, idx = tknn.ivf_search(index, torch.from_numpy(x[:200]), 5, nprobe=8, self_query=True)
    sq_ex, idx_ex = tknn.knn_search(torch.from_numpy(x), torch.from_numpy(x[:200]), 5,
                                    self_query=True)
    recall = np.mean([len(set(map(int, a)) & set(map(int, b))) / 5.0
                      for a, b in zip(idx.numpy(), idx_ex.numpy())])
    assert recall > 0.8, recall
    # JAX's index on the same data is bounded by the same cap
    jindex = jknn.ivf_build(jnp.asarray(x), nlist=16)
    assert np.asarray(jindex.lists).shape[1] <= cap


@pytest.mark.parametrize("backend", ["host", "ivf"])
def test_build_graph_backends_match_the_exact_search(backend):
    """On a small ring the host backend finds the exact graph up to f32
    ties, IVF with enough probes finds it exactly, and
    ``NearestNeighbors(use_ivf=True)`` builds the same."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 2 * np.pi, 1500))
    x = (np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], 1)
         + 0.01 * rng.standard_normal((1500, 3))).astype(np.float32)
    with pytest.raises(ValueError, match="knn_backend"):
        build_graph(x, 8, knn_backend="faiss", device="cpu")
    exact = build_graph(x, 8, device="cpu")
    g = build_graph(x, 8, knn_backend=backend, ivf_nlist=32, ivf_nprobe=8, device="cpu")
    if backend == "host":
        # the host search ranks by the expanded form |q|^2 + |x|^2 - 2 q.x:
        # a pick it makes differently lies within f32 rounding of the k-th
        # neighbour's distance (|x|^2 <= 1.1 here)
        keys = [g.rows.numpy() * 1500 + g.cols.numpy(),
                exact.rows.numpy() * 1500 + exact.cols.numpy()]
        assert np.setxor1d(*keys).size <= 1e-3 * keys[1].size
        _, idx_h = native.knn_search_host(x, x, 8)
        _, idx_e = tknn.knn_search(torch.from_numpy(x), torch.from_numpy(x), 8, self_query=True)
        x64 = x.astype(np.float64)
        for r in np.flatnonzero((np.sort(idx_h[:, 1:], 1) != np.sort(idx_e.numpy()[:, 1:], 1))
                                .any(1)):
            d = np.sum((x64 - x64[r]) ** 2, axis=1)
            d[r] = np.inf
            assert d[idx_h[r, 1:]].max() - np.partition(d, 6)[6] <= 1e-6, r
        return
    for name in ("rows", "cols", "sqdist", "ell_col"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(exact, name).numpy())
    nn = tknn.NearestNeighbors(torch.from_numpy(x), use_ivf=True, nlist=32, nprobe=8)
    np.testing.assert_array_equal(nn.graph(8).rows.numpy(), exact.rows.numpy())


def test_host_backend_pins_the_self_match():
    """Points within f32 rounding of each other: the host search's expanded
    form gives both distances 0 and may rank the other point first. JAX's
    host backend then keeps a self-loop and its graph assembly raises; the
    port pins each self-match to column 0 (``pin_self_match``) and builds
    the device search's graph."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((400, 3)).astype(np.float32)
    x[200:210] = x[100:110]  # exact duplicates
    _, idx = native.knn_search_host(x, x, 6)
    assert (idx[:, 0] != np.arange(400)).any()
    with pytest.raises(ValueError, match="self-loop"):
        j_build_graph(x, 6, knn_backend="host")
    g = build_graph(x, 6, knn_backend="host", device="cpu")
    exact = build_graph(x, 6, device="cpu")
    keys = [a.rows.numpy() * 400 + a.cols.numpy() for a in (g, exact)]
    assert np.setxor1d(*keys).size <= 1e-2 * keys[1].size  # duplicates tie with each other
    sqd, pinned = pin_self_match(*native.knn_search_host(x, x, 6))
    assert (pinned[:, 0] == np.arange(400)).all() and (sqd[:, 0] == 0).all()
