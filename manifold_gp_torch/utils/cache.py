"""Keyed on-disk cache for the kNN graph and the spectral basis (port of
``manifold_gp_tpu.utils.cache``).

Keys are content hashes, byte for byte those of the JAX package for the
same inputs, and entries are the same ``.npz`` files, so an entry written by
either package loads in the other:

  * graph: sha256(f32 data bytes, k, backend, builder version): the
    bandwidth-independent edge structure;
  * basis: sha256(int32 edge rows / cols, f32 squared distances, modes,
    normalization, eigensolver settings, the f32 bytes of the graph
    bandwidth): a moved bandwidth is another Laplacian, so another key.

A lookup with another key misses; ``clear_cache`` removes every entry.
Writes are atomic (tmp + rename); a corrupt entry is evicted and rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile

import numpy as np
import torch

from ..config import resolve_device

# Version of the graph builders' edge-value semantics (v3: exact
# coordinate-differenced edge lengths and an exact re-ranked neighbour
# choice), the same in both packages, so their entries share the key.
_GRAPH_BUILDER_VERSION = 3
# what np.load raises on a truncated or foreign entry
_CORRUPT = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _atomic_save(path: str, **arrays):
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def graph_cache_key(x, nearest_neighbors: int, backend: str = "device") -> str:
    x = np.ascontiguousarray(_np(x).astype(np.float32, copy=False))
    h = hashlib.sha256()
    h.update(x.tobytes())
    h.update(
        f"|k={int(nearest_neighbors)}|backend={backend}"
        f"|v={_GRAPH_BUILDER_VERSION}".encode()
    )
    return h.hexdigest()[:32]


def cached_graph(x, nearest_neighbors: int, cache_dir: str, knn_backend: str = "device",
                 builder=None, device=None):
    """``ops.graph.build_graph`` with an on-disk cache. Returns (graph, hit).

    ``builder()`` overrides the build call (a caller's own search, with a
    ``knn_backend`` string that names it for the key). ``device``: where the
    graph lives (default: the device of ``x`` when it is a tensor, else
    CUDA, which raises without a card)."""
    from ..ops.graph import build_graph, graph_from_edges

    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else resolve_device("cuda")
    key = graph_cache_key(x, nearest_neighbors, knn_backend)
    path = os.path.join(cache_dir, f"graph_{key}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                graph = graph_from_edges(z["rows"], z["cols"], z["sqdist"],
                                         int(z["num_nodes"]), device=device)
            return graph, True
        except _CORRUPT:
            os.unlink(path)  # corrupt entry: evict and rebuild
    graph = (builder() if builder is not None
             else build_graph(x, nearest_neighbors, knn_backend=knn_backend, device=device))
    _atomic_save(
        path,
        rows=_np(graph.rows).astype(np.int32),
        cols=_np(graph.cols).astype(np.int32),
        sqdist=_np(graph.sqdist).astype(np.float32),
        num_nodes=np.int64(graph.num_nodes),
    )
    return graph, False


def basis_cache_key(kernel, graphbandwidth) -> str:
    gb = np.float32(_np(graphbandwidth).reshape(()))
    h = hashlib.sha256()
    h.update(_np(kernel.graph.rows).astype(np.int32).tobytes())
    h.update(_np(kernel.graph.cols).astype(np.int32).tobytes())
    h.update(_np(kernel.graph.sqdist).astype(np.float32).tobytes())
    h.update(
        f"|m={kernel.num_modes}|norm={kernel.laplacian_normalization}"
        f"|eigh_max={kernel.cfg.eigh_max_size}"
        f"|eig_iter={kernel.cfg.eigensolver_max_iter}"
        f"|solver={kernel.cfg.eigensolver}"
        f"|cheb={kernel.cfg.cheb_degree}x{kernel.cfg.cheb_iters}".encode()
    )
    h.update(gb.tobytes())
    return h.hexdigest()[:32]


def cached_eval_basis(kernel, params, cache_dir: str):
    """``kernel.eval_basis`` with an on-disk cache keyed by the graph
    structure, the basis settings and the current graph bandwidth.
    Returns ((eigval, eigvec), hit), as f32 tensors on the kernel's device."""
    with torch.no_grad():
        key = basis_cache_key(kernel, kernel.graphbandwidth(params))
    path = os.path.join(cache_dir, f"basis_{key}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return (torch.from_numpy(z["eigval"]).to(kernel.device),
                        torch.from_numpy(z["eigvec"]).to(kernel.device)), True
        except _CORRUPT:
            os.unlink(path)
    eigval, eigvec = kernel.eval_basis(params)
    _atomic_save(path, eigval=_np(eigval).astype(np.float32),
                 eigvec=_np(eigvec).astype(np.float32))
    return (eigval, eigvec), False


def clear_cache(cache_dir: str):
    """Remove every cache entry (graph_*.npz / basis_*.npz) in the directory;
    returns how many."""
    if not os.path.isdir(cache_dir):
        return 0
    n = 0
    for f in os.listdir(cache_dir):
        if (f.startswith("graph_") or f.startswith("basis_")) and f.endswith(".npz"):
            os.unlink(os.path.join(cache_dir, f))
            n += 1
    return n
