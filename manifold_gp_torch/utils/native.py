"""ctypes bindings for the native host runtime (port of
``manifold_gp_tpu.utils.native``).

The package keeps its own copy of the C++ source, ``csrc/manifold_native.cc``
(host exact kNN, duplicate-edge coalescing, single-source Dijkstra), and
compiles it with g++ at first use into the package's build directory, named
by a digest of the source and the flags. A failed build raises: the entry
points do not fall back. The numpy/scipy versions beside them
(``knn_search_plain``, ``dijkstra_plain``; ``ops.graph.coalesce_mean``) are
the plain versions the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "manifold_native.cc"
_BUILD_DIR = _PKG / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lib = None
_lib_lock = threading.Lock()


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("manifold_native: no C++ compiler (g++) on PATH")
    return found


def build_native() -> pathlib.Path:
    """Compile the native library (once per content of the source and the
    flags) and return its path. Raises when the compiler fails."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    lib_path = _BUILD_DIR / f"libmanifold_native-{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"libmanifold_native.{os.getpid()}.tmp"
    try:
        res = subprocess.run([_cxx(), *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"manifold_native: g++ failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
    return lib_path


def get_lib():
    """The loaded library (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            f32p, i64p, f64p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_double))
            i64 = ctypes.c_int64
            lib.exact_knn.argtypes = [f32p, i64, i64, f32p, i64, i64, f32p, i64p]
            lib.exact_knn.restype = None
            lib.coalesce_mean.argtypes = [i64p, i64p, f64p, i64, i64, i64p, i64p, f64p]
            lib.coalesce_mean.restype = ctypes.c_int64
            lib.dijkstra.argtypes = [i64, i64p, i64p, f32p, i64, f32p]
            lib.dijkstra.restype = None
            _lib = lib
    return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def knn_search_host(database, queries, k: int):
    """Exact host kNN over all cores: (sqdist [Nq, k] float32 ascending,
    idx [Nq, k] int64), like ``ops.knn.knn_search`` without the self pin.
    Distances are the expanded form |q|^2 + |x|^2 - 2 q.x, clamped at 0."""
    db = np.ascontiguousarray(database, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    if db.ndim != 2 or q.ndim != 2 or q.shape[1] != db.shape[1] or k < 1:
        raise ValueError(f"knn_search_host: database {db.shape}, queries {q.shape}, k={k}")
    lib = get_lib()
    out_d = np.empty((q.shape[0], k), np.float32)
    out_i = np.empty((q.shape[0], k), np.int64)
    lib.exact_knn(_fptr(db), db.shape[0], db.shape[1], _fptr(q), q.shape[0], k,
                  _fptr(out_d), _iptr(out_i))
    return out_d, out_i


def knn_search_plain(database, queries, k: int, block_size: int = 512):
    """The numpy version of ``knn_search_host`` (blocked)."""
    db = np.ascontiguousarray(database, np.float32)
    q = np.ascontiguousarray(queries, np.float32)
    dn = (db * db).sum(1)
    out_d = np.empty((q.shape[0], k), np.float32)
    out_i = np.empty((q.shape[0], k), np.int64)
    for s in range(0, q.shape[0], block_size):
        qb = q[s:s + block_size]
        d = (qb * qb).sum(1)[:, None] + dn[None, :] - 2 * qb @ db.T
        np.maximum(d, 0, out=d)
        part = np.argpartition(d, min(k, d.shape[1] - 1), axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        out_i[s:s + block_size] = np.take_along_axis(part, order, axis=1)
        out_d[s:s + block_size] = np.take_along_axis(pd, order, axis=1)
    return out_d, out_i


def coalesce_mean_host(rows, cols, vals, num_nodes):
    """Native duplicate-edge merge: sorted COO (int32, int32, float32) with
    duplicate pairs averaged, as ``ops.graph.coalesce_mean``."""
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    v = np.ascontiguousarray(vals, np.float64)
    if not (r.ndim == c.ndim == v.ndim == 1 and r.shape == c.shape == v.shape):
        raise ValueError(f"coalesce_mean_host: rows {r.shape}, cols {c.shape}, vals {v.shape}")
    out_r, out_c, out_v = np.empty_like(r), np.empty_like(c), np.empty_like(v)
    m = get_lib().coalesce_mean(_iptr(r), _iptr(c), _dptr(v), r.shape[0], num_nodes,
                                _iptr(out_r), _iptr(out_c), _dptr(out_v))
    return out_r[:m].astype(np.int32), out_c[:m].astype(np.int32), out_v[:m].astype(np.float32)


def dijkstra_host(num_nodes, indptr, indices, weights, source: int = 0):
    """Native single-source geodesics over an undirected CSR graph (float32)."""
    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int64)
    w = np.ascontiguousarray(weights, np.float32)
    if ip.shape != (num_nodes + 1,) or ix.shape != w.shape or not 0 <= source < num_nodes:
        raise ValueError(f"dijkstra_host: indptr {ip.shape}, indices {ix.shape}, weights "
                         f"{w.shape}, source {source} for {num_nodes} nodes")
    if ix.size and (ix.min() < 0 or ix.max() >= num_nodes or ip[-1] != ix.size):
        raise ValueError("dijkstra_host: CSR indices out of range")
    out = np.empty(num_nodes, np.float32)
    get_lib().dijkstra(num_nodes, _iptr(ip), _iptr(ix), _fptr(w), source, _fptr(out))
    return out


def dijkstra_plain(num_nodes, indptr, indices, weights, source: int = 0):
    """The scipy version of ``dijkstra_host``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    g = sp.csr_matrix((weights, indices, indptr), shape=(num_nodes, num_nodes))
    return dijkstra(g, directed=False, indices=source).astype(np.float32)
