"""Twin of tests/test_sharded_knn.py: the port's row-sharded exact kNN
search (both database schedules), graph build, ``NearestNeighbors(mesh=)``
and sharded IVF search (``manifold_gp_torch.parallel.knn``) at world sizes
2 and 4 (gloo processes on the CPU, ``_torch_mesh_worker``, one start of
each world), held to JAX's single-device ``knn_search`` / ``ivf_search`` /
``build_graph`` and to its 8-device ``sharded_*`` results with the JAX
test's ``assert_topk_equal``, and to the port's single-device IVF search.
JAX's references are computed while the ranks run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from manifold_gp_tpu.ops.graph import build_graph
from manifold_gp_tpu.ops.knn import ivf_build, ivf_search, knn_search
from manifold_gp_tpu.parallel import make_mesh, sharded_knn_search
from manifold_gp_tpu.parallel.knn import sharded_ivf_search
from test_sharded_knn import assert_topk_equal

WORLD_SIZES = (2, 4)


def _problems():
    """tests/test_sharded_knn.py's inputs."""
    rng = np.random.default_rng(42)
    n = 2048
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    cloud = np.stack([np.cos(t), np.sin(t), 0.3 * np.sin(2 * t)], 1)
    cloud = (cloud + 0.01 * rng.standard_normal(cloud.shape)).astype(np.float32)
    rng = np.random.default_rng(3)
    db_uneven = rng.standard_normal((1003, 4)).astype(np.float32)
    q_uneven = rng.standard_normal((130, 4)).astype(np.float32)
    rng = np.random.default_rng(9)
    # the JAX test's k = 50 exceeds its 8-way shards of 350 rows (44); here
    # it exceeds the shards of the first 90 rows (45 and 23 at 2 and 4 ranks)
    db_small = rng.standard_normal((350, 3)).astype(np.float32)[:90]
    q_small = rng.standard_normal((64, 3)).astype(np.float32)
    rng = np.random.default_rng(3)
    q_ivf = cloud[:333] + 0.01 * rng.standard_normal((333, 3)).astype(np.float32)
    # the JAX index: the same quantizer and lists for both packages
    index = ivf_build(cloud, nlist=32)
    index_np = tuple(np.asarray(a) for a in (index.centroids, index.lists, index.list_mask,
                                             index.database))
    x = cloud
    y = np.sin(3 * np.arctan2(x[:, 1], x[:, 0])).astype(np.float32)
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (x.shape[0], 8),
                                              dtype=jnp.float32))
    return dict(cloud=cloud, q_oos=(cloud[:777] + 0.02).astype(np.float32),
                db_uneven=db_uneven, q_uneven=q_uneven, db_small=db_small, q_small=q_small,
                q_ivf=q_ivf, q_pad=(cloud[:64] + 0.01).astype(np.float32),
                k_pad=2 * index_np[1].shape[1], index=index, index_np=index_np, y=y,
                probes=probes, xs=(x[:512][::13] + 0.01).astype(np.float32))


def _scenarios(p):
    return [
        ("knn_searches", dict(cloud=p["cloud"], q_oos=p["q_oos"], db_uneven=p["db_uneven"],
                              q_uneven=p["q_uneven"], db_small=p["db_small"],
                              q_small=p["q_small"])),
        ("sharded_ivf", dict(index=p["index_np"], cloud=p["cloud"], q_oos=p["q_ivf"],
                             q_pad=p["q_pad"], k_pad=p["k_pad"])),
        ("mesh_graph_model", dict(x=p["cloud"], y=p["y"], probes=p["probes"], x_oos_n=512,
                                  xs=p["xs"])),
    ]


def _jax_references(p):
    """JAX's single-device searches and graphs, and its 8-device sharded
    search and IVF (the JAX test's mesh from conftest's virtual devices)."""
    cloud = p["cloud"]
    mesh = make_mesh(8)
    index = p["index"]

    def np2(pair):
        return tuple(np.asarray(a) for a in pair)

    ref = {
        "self": np2(knn_search(cloud, cloud, 9, self_query=True)),
        "oos": np2(knn_search(cloud, p["q_oos"], 5)),
        "uneven": np2(knn_search(p["db_uneven"], p["q_uneven"], 7)),
        "kbig": np2(knn_search(p["db_small"], p["q_small"], 50)),
        "self6": np2(knn_search(cloud, cloud, 6, self_query=True)),
        "ivf_self": np2(ivf_search(index, cloud, 9, nprobe=8, self_query=True)),
        "ivf_oos": np2(ivf_search(index, p["q_ivf"], 9, nprobe=8)),
        "ivf_self7": np2(ivf_search(index, cloud, 7, nprobe=8, self_query=True)),
        "ivf_pad": np2(ivf_search(index, p["q_pad"], p["k_pad"], nprobe=2)),
        "jax8_ivf_self": np2(sharded_ivf_search(index, cloud, 9, mesh, nprobe=8,
                                                self_query=True, block_size=64)),
    }
    for sched in ("replicated", "ring"):
        ref[f"jax8_{sched}"] = np2(sharded_knn_search(cloud, cloud, 9, mesh, self_query=True,
                                                      schedule=sched, block_size=128))
    for k in (8, 6):
        g = build_graph(cloud, k)
        ref[f"graph{k}"] = {"rows": np.asarray(g.rows), "cols": np.asarray(g.cols),
                            "sqdist": np.asarray(g.sqdist), "ell_col": np.asarray(g.ell_col),
                            "max_degree": g.max_degree, "num_edges": g.num_edges}
    return ref


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    return W.run_worlds_async(WORLD_SIZES, _scenarios(problems),
                              tmp_path_factory.mktemp("knn"), together=True)


@pytest.fixture(scope="module")
def ref(problems, worlds):
    return _jax_references(problems)


@pytest.fixture(scope="module")
def runs(ref, worlds):
    return worlds.result()


def _each_rank(runs, ws, idx):
    """Every rank's result of scenario ``idx`` (each rank gathers the full
    result)."""
    return [r[idx] for r in runs[ws]]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same(a[key], b[key])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _same_edges(got, want):
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["cols"], want["cols"])
    np.testing.assert_allclose(got["sqdist"], want["sqdist"], rtol=1e-6, atol=1e-7)
    assert got["max_degree"] == want["max_degree"]
    np.testing.assert_array_equal(got["ell_col"], want["ell_col"])


def _overlap(got, want):
    a = set(zip(got["rows"].tolist(), got["cols"].tolist()))
    b = set(zip(want["rows"].tolist(), want["cols"].tolist()))
    return len(a & b) / len(b)


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("schedule", ["replicated", "ring"])
def test_sharded_search_matches_single_device(ref, runs, ws, schedule):
    """Self-query search on both schedules: JAX's single-device exact
    search and its 8-device sharded one, on every rank."""
    for r in _each_rank(runs, ws, 0):
        d, i = r[f"self_{schedule}"]
        assert_topk_equal(d, i, *ref["self"])
        assert_topk_equal(d, i, *ref[f"jax8_{schedule}"])
        np.testing.assert_array_equal(i[:, 0], np.arange(d.shape[0]))


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("schedule", ["replicated", "ring"])
def test_sharded_search_out_of_sample(ref, runs, ws, schedule):
    """777 plain queries, not divisible by the world size."""
    for r in _each_rank(runs, ws, 0):
        assert_topk_equal(*r[f"oos_{schedule}"], *ref["oos"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_ring_search_uneven_database(ref, runs, ws):
    """1,003 database rows (not divisible by the world size): padded rows
    never appear as neighbours."""
    for r in _each_rank(runs, ws, 0):
        d, i = r["uneven_ring"]
        assert_topk_equal(d, i, *ref["uneven"])
        assert i.max() < 1003 and i.min() >= 0


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_ring_search_k_exceeds_shard(ref, runs, ws):
    """k = 50 above a shard's rows (90 database rows: 45 a shard at world
    size 2, 23 at 4): each step's top-k is padded, the merges discard the
    padding, the result is the global top-k."""
    for r in _each_rank(runs, ws, 0):
        assert_topk_equal(*r["kbig_ring"], *ref["kbig"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("schedule", ["replicated", "ring"])
def test_sharded_graph_build_matches_single_device(ref, runs, ws, schedule):
    """``build_graph_sharded`` against JAX's ``build_graph``: edge list,
    values, ELL tables."""
    for r in _each_rank(runs, ws, 0):
        _same_edges(r[f"graph_{schedule}"], ref["graph8"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_build_feeds_kernel(runs, ws):
    """The sharded-built graph, injected into a single-device kernel, gives
    the loss of the kernel's own build (same probes)."""
    for r in _each_rank(runs, ws, 2):
        np.testing.assert_allclose(r["loss_sharded"], r["loss_own"], rtol=1e-5)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_nearest_neighbors_wrapper_mesh(ref, runs, ws):
    """``NearestNeighbors(mesh=)`` searches and builds through the sharded
    search (its own points as queries: the self-match pinned)."""
    for r in _each_rank(runs, ws, 0):
        assert_topk_equal(*r["nn_search"], *ref["self6"])
        g = r["nn_graph"]
        np.testing.assert_array_equal(g["rows"], ref["graph6"]["rows"])
        np.testing.assert_allclose(g["sqdist"], ref["graph6"]["sqdist"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_kernel_oos_features_through_injected_index(runs, ws):
    """A kernel given ``NearestNeighbors(x, mesh=)`` as ``knn_index``
    serves the default index's out-of-sample posterior."""
    for r in _each_rank(runs, ws, 2):
        for got, want in zip(r["post_mesh"], r["post_default"]):
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_nearest_neighbors_mesh_ivf_compose(ref, runs, ws):
    """``NearestNeighbors(mesh=, use_ivf=True)`` at full probing (32 of
    32 lists): the exact search's results, and > 98 % of the exact graph's
    edges."""
    for r in _each_rank(runs, ws, 0):
        assert_topk_equal(*r["nn_ivf_search"], *ref["self6"])
        assert _overlap(r["nn_ivf_graph"], ref["graph6"]) > 0.98


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_ivf_matches_single_device(ref, runs, ws):
    """On JAX's index: the sharded IVF equals the port's single-device IVF
    exactly and JAX's single-device and 8-device IVF within
    ``assert_topk_equal`` (self-query, and 333 out-of-sample queries)."""
    for r in _each_rank(runs, ws, 1):
        for case, jref in (("self", "ivf_self"), ("oos", "ivf_oos")):
            sh, one = r[case]["sharded"], r[case]["single"]
            np.testing.assert_array_equal(sh[1], one[1])
            np.testing.assert_array_equal(sh[0], one[0])
            assert_topk_equal(*sh, *ref[jref])
        assert_topk_equal(*r["self"]["sharded"], *ref["jax8_ivf_self"])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_ivf_chunked_dispatch(ref, runs, ws):
    """Chunks of 512 queries split over the ranks keep the global self-match
    rows: column 0 is every query's own id."""
    for r in _each_rank(runs, ws, 1):
        d, i = r["chunked"]["sharded"]
        assert_topk_equal(d, i, *ref["ivf_self7"])
        np.testing.assert_array_equal(i, r["chunked"]["single"][1])
        np.testing.assert_array_equal(i[:, 0], np.arange(i.shape[0]))


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_sharded_ivf_padding_gets_id_minus_one(ref, runs, ws):
    """k = twice the padded list width over 2 probed lists: past a query's
    valid candidates the result holds padding slots. The port gives them
    +inf and id -1 (as its single-device search does); JAX's search gives
    id 0, an alias of database row 0 (its sharded IVF shares the fault:
    ROADMAP queue 3). Every valid entry equals JAX's."""
    jd, ji = ref["ivf_pad"]
    pad = ~np.isfinite(jd)
    assert pad.any() and (ji[pad] == 0).all()  # the reference's alias
    for r in _each_rank(runs, ws, 1):
        d, i = r["pad"]["sharded"]
        np.testing.assert_array_equal(~np.isfinite(d), pad)
        assert (i[pad] == -1).all()
        assert_topk_equal(np.where(pad, 0.0, d), np.where(pad, 0, i), np.where(pad, 0.0, jd), ji)
        np.testing.assert_array_equal(i, r["pad"]["single"][1])


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_every_rank_returns_the_same_result(runs, ws):
    """Each rank gathers the whole result: the ranks' searches, graphs and
    IVF results are equal bit for bit."""
    for r in runs[ws][1:]:
        _assert_same(r[:2], runs[ws][0][:2])
