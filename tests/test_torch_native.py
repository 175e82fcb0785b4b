"""The port's native host runtime (``utils/native.py``, twin of
``tests/test_native.py``): the g++ build of the package's own copy of the
C++ source, held to the numpy / scipy plain versions and to the JAX
package's functions on the same inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra as sp_dijkstra

from manifold_gp_tpu.ops.graph import coalesce_mean as j_coalesce_mean
from manifold_gp_tpu.utils import native as jnative
from manifold_gp_torch.ops.graph import coalesce_mean
from manifold_gp_torch.utils import native


def test_native_builds():
    """The library builds from the package's copy into its build directory,
    named by the source's digest, and loads; the JAX package's ``native/``
    is not written."""
    path = native.build_native()
    assert path.parent == native._BUILD_DIR and path.exists()
    assert path.name.startswith("libmanifold_native-") and path.suffix == ".so"
    assert native.get_lib() is not None
    assert native._SOURCE.parent.name == "csrc" and native._SOURCE.exists()


def test_knn_host_matches_numpy():
    rng = np.random.default_rng(41)
    db = rng.standard_normal((200, 8)).astype(np.float32)
    q = rng.standard_normal((33, 8)).astype(np.float32)
    d, i = native.knn_search_host(db, q, 7)
    full = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    oi = np.argsort(full, axis=1)[:, :7]
    od = np.take_along_axis(full, oi, axis=1)
    np.testing.assert_allclose(d, od, rtol=1e-3, atol=1e-4)
    assert np.array_equal(i, oi)
    pd, pi = native.knn_search_plain(db, q, 7)
    assert np.array_equal(pi, oi)
    np.testing.assert_allclose(d, pd, rtol=1e-5, atol=1e-5)
    jd, ji = jnative.knn_search_host(db, q, 7)
    assert np.array_equal(np.asarray(ji, np.int64), i)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)


def test_coalesce_host_matches_python():
    rows = np.array([3, 0, 0, 1, 0], np.int64)
    cols = np.array([4, 1, 2, 2, 1], np.int64)
    vals = np.array([9.0, 1.0, 4.0, 5.0, 3.0])
    r, c, v = native.coalesce_mean_host(rows, cols, vals, 5)
    r2, c2, v2 = coalesce_mean(rows, cols, vals, 5)
    assert np.array_equal(r, r2) and np.array_equal(c, c2)
    np.testing.assert_allclose(v, v2)
    r3, c3, v3 = j_coalesce_mean(rows, cols, vals, 5)
    assert np.array_equal(r, r3) and np.array_equal(c, c3)
    np.testing.assert_array_equal(v, v3)


def test_dijkstra_host_matches_scipy():
    rng = np.random.default_rng(43)
    n = 50
    rows = rng.integers(0, n, 200)
    cols = rng.integers(0, n, 200)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    w = rng.uniform(0.1, 2.0, rows.shape[0]).astype(np.float32)
    g = sp.csr_matrix(
        (np.concatenate([w, w]), (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n))
    chain = sp.csr_matrix(
        (np.full(n - 1, 5.0, np.float32), (np.arange(n - 1), np.arange(1, n))), shape=(n, n))
    g = (g + chain + chain.T).tocsr()
    expected = sp_dijkstra(g, directed=False, indices=0)
    args = (n, g.indptr.astype(np.int64), g.indices.astype(np.int64), g.data, 0)
    got = native.dijkstra_host(*args)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(native.dijkstra_plain(*args), expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, jnative.dijkstra_host(*args))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source the compiler rejects raises; nothing falls back to the plain
    versions, and no library is left behind."""
    bad = tmp_path / "manifold_native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.knn_search_host(np.zeros((4, 2), np.float32), np.zeros((1, 2), np.float32), 2)
    assert list((tmp_path / "build").iterdir()) == []
