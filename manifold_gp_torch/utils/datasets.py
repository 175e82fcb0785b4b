"""Dataset loaders: 1D dumbbell mesh, 2D dragon mesh, rotated MNIST (port of
``manifold_gp_tpu.utils.datasets``).

Host numpy and scipy functions that return numpy arrays, as in the JAX
package; the port keeps its own copy of the data they read in
``manifold_gp_torch/data/``:
  * ``dumbbell.npz`` (vertices, edges of the 1-D mesh) and ``dragon.npz``
    (vertices, faces of the decimated Stanford dragon);
  * ``digits.npz``: scikit-learn's bundled 1,797 8x8 digits (uint8, 0-16)
    and their labels, the offline stand-in for MNIST (written by
    ``tests/_digits_data.py``; the port never imports scikit-learn).

Re-implements the reference ``manifold_gp/utils/load_dataset.py`` pipeline:
  * the gmsh section parser (:148-181) is ``parse_msh``;
  * networkx single-source shortest paths (:82-106) are
    ``scipy.sparse.csgraph.dijkstra`` on a CSR edge graph;
  * trimesh STL loading (:109-145) is a small binary/ASCII STL reader;
  * the tensorflow MNIST fetch (:36-51) is a loader that looks for a local
    ``mnist.npz`` (keras layout) and otherwise falls back to the digits,
    upsampled to 28x28: same shapes, same rotation-manifold structure, no
    network access.

Ground truth as in the reference:
  1D: y = 2 sin(geodesic * 1.5)         (:97-104)
  2D: y = 2 sin(geodesic * 1.0 + 0.3)   (:137-143)
  RMNIST: y = rotation angle in [-45, 45] degrees, pixel scaling
  (x - 127.5) / 255 (:75-77).

``rmnist_dataset`` caches what it builds as ``{srmnist,rmnist}_cache.npz``
in ``cache_dir`` (default: the port's ``data/``). The cache key is only the
variant: ``rots_train``, ``rots_test`` and ``seed`` are not part of it, so
a small build and a full-size one must not share a ``cache_dir``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

_DATA_DIR = pathlib.Path(__file__).resolve().parent.parent / "data"


# ---------------------------------------------------------------------------
# Mesh parsing
# ---------------------------------------------------------------------------


def parse_msh(path):
    """Parse the simple Nodes/Elements sections of a .msh file.

    Returns (vertices [N, 2], edges [E, 2] 0-indexed int).
    """
    nodes, elements = [], []
    section = None
    with open(path) as fh:
        for line in fh:
            stripped = line.strip()
            if not stripped:
                continue
            if "Nodes" in stripped and not stripped[0].isdigit():
                section = "nodes" if not stripped.startswith("End") else None
                continue
            if "Elements" in stripped and not stripped[0].isdigit():
                section = "elements" if not stripped.startswith("End") else None
                continue
            if stripped.startswith("$"):
                section = None
                continue
            parts = stripped.split()
            if section == "nodes":
                nodes.append([float(p) for p in parts])
            elif section == "elements":
                elements.append([float(p) for p in parts])
    nodes = np.asarray(nodes, np.float64)
    elements = np.asarray(elements, np.float64)
    vertices = nodes[:, 1:-1]
    edges = elements[:, -2:].astype(np.int64) - 1
    return vertices, edges


def parse_stl(path):
    """Read a binary (or ASCII) STL file. Returns (vertices [N,3], faces [F,3])."""
    path = str(path)
    with open(path, "rb") as fh:
        header = fh.read(80)
        rest = fh.read()
    if header[:5] == b"solid" and b"facet" in rest[:500]:
        verts = []
        for line in rest.decode("ascii", "ignore").splitlines():
            t = line.strip().split()
            if t[:1] == ["vertex"]:
                verts.append([float(t[1]), float(t[2]), float(t[3])])
        tri = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    else:
        ntri = int(np.frombuffer(rest[:4], np.uint32)[0])
        rec = np.frombuffer(rest[4 : 4 + 50 * ntri], dtype=np.uint8).reshape(ntri, 50)
        data = rec[:, :48].copy().view(np.float32).reshape(ntri, 4, 3)
        tri = data[:, 1:4, :].astype(np.float64)
    flat = tri.reshape(-1, 3)
    vertices, inverse = np.unique(flat.round(8), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    return vertices, faces


def _unique_edges_from_faces(faces):
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def geodesics_from_edges(vertices, edges, source: int = 0):
    """Single-source geodesic distances over the mesh edge graph."""
    lengths = np.linalg.norm(vertices[edges[:, 0]] - vertices[edges[:, 1]], axis=1)
    n = vertices.shape[0]
    g = sp.csr_matrix(
        (
            np.concatenate([lengths, lengths]),
            (
                np.concatenate([edges[:, 0], edges[:, 1]]),
                np.concatenate([edges[:, 1], edges[:, 0]]),
            ),
        ),
        shape=(n, n),
    )
    return dijkstra(g, directed=False, indices=source)


# ---------------------------------------------------------------------------
# Reference datasets
# ---------------------------------------------------------------------------


def _mesh_path(env: str, kind: str):
    path = os.environ.get(env)
    if not path:
        raise FileNotFoundError(f"no {kind} mesh: pass its path or set {env}")
    return path


def manifold_1D_dataset(msh_path=None):
    """Dumbbell 1D mesh: (vertices [N,2] f32, truth [N] f32, edges [E,2]).

    Ground truth y = 2 sin(geodesic * 1.5), reference load_dataset.py:97-104.
    """
    if msh_path is None:
        npz = _DATA_DIR / "dumbbell.npz"
        if npz.exists():
            d = np.load(npz)
            vertices, edges = d["vertices"], d["edges"]
        else:  # pragma: no cover - a reference .msh named by the environment
            vertices, edges = parse_msh(_mesh_path("MANIFOLD_GP_DUMBBELL", "dumbbell"))
    else:
        vertices, edges = parse_msh(msh_path)
    geo = geodesics_from_edges(vertices, edges)
    truth = 2.0 * np.sin(geo * 1.5)
    return vertices.astype(np.float32), truth.astype(np.float32), edges


def manifold_2D_dataset(stl_path=None):
    """Dragon mesh: (vertices [N,3] f32, truth [N] f32).

    Ground truth y = 2 sin(geodesic + 0.3), reference load_dataset.py:137-143.
    """
    if stl_path is None:
        npz = _DATA_DIR / "dragon.npz"
        if npz.exists():
            d = np.load(npz)
            vertices, faces = d["vertices"], d["faces"]
        else:  # pragma: no cover - a reference .stl named by the environment
            vertices, faces = parse_stl(_mesh_path("MANIFOLD_GP_DRAGON", "dragon"))
    else:
        vertices, faces = parse_stl(stl_path)
    edges = _unique_edges_from_faces(faces)
    geo = geodesics_from_edges(vertices, edges)
    truth = 2.0 * np.sin(geo * 1.0 + 0.3)
    return vertices.astype(np.float32), truth.astype(np.float32)


# ---------------------------------------------------------------------------
# Rotated MNIST
# ---------------------------------------------------------------------------


def _load_mnist_train():
    """Return (images [60000, 28, 28] uint8, labels) from a local file, or
    None if there is none (no network access is ever attempted): the file
    named by ``MNIST_NPZ``, the keras cache, then the port's ``data/``."""
    candidates = [
        os.environ.get("MNIST_NPZ", ""),
        os.path.expanduser("~/.keras/datasets/mnist.npz"),
        str(_DATA_DIR / "mnist.npz"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            d = np.load(c)
            return d["x_train"], d["y_train"]
    return None


def _surrogate_digits():
    """Deterministic offline stand-in for MNIST: the 8x8 digits of
    ``data/digits.npz``, bicubic-upsampled to 28x28 and scaled to [0, 255].
    The images are cast to float64 before the zoom, as ``load_digits()``
    hands them over (zooming the uint8 array gives other numbers)."""
    from scipy import ndimage

    d = np.load(_DATA_DIR / "digits.npz")
    imgs = d["images"].astype(np.float64)  # [1797, 8, 8] in [0, 16]
    up = ndimage.zoom(imgs, (1, 3.5, 3.5), order=3)  # -> [1797, 28, 28]
    up = np.clip(up / 16.0 * 255.0, 0, 255)
    return up.astype(np.uint8), d["target"].astype(np.int64)


def rotate_mnist(samples, labels, num_samples, rots_sample, rng=None, shuffle=False):
    """Rotation augmentation, mirroring reference rotate_mnist.py:11-31:
    for each of the first num_samples images emit the original (angle 0)
    followed by rots_sample uniformly-random rotations in [-45, 45] degrees;
    target y = the rotation angle."""
    from scipy import ndimage

    rng = np.random.default_rng(0) if rng is None else rng
    rotations = rng.uniform(low=-45, high=45, size=(num_samples, rots_sample))
    per = rots_sample + 1
    x = np.zeros((num_samples * per, 28, 28))
    y = np.zeros((num_samples * per,))
    lab = np.zeros((num_samples * per,))
    for i in range(num_samples):
        x[i * per] = samples[i]
        lab[i * per] = labels[i]
        for j in range(rots_sample):
            x[i * per + j + 1] = ndimage.rotate(
                samples[i], rotations[i, j], reshape=False
            )
            y[i * per + j + 1] = rotations[i, j]
            lab[i * per + j + 1] = labels[i]
    if shuffle:
        idx = rng.permutation(x.shape[0])
        x, y, lab = x[idx], y[idx], lab[idx]
    return x, y, lab


# The reference's fixed training-set indices for the single-digit variant
# (load_dataset.py:41: one exemplar of each class 0-9).
_SRMNIST_DIGIT_IDX = [1, 8, 5, 7, 2, 0, 18, 15, 17, 4]


def _cache_file(cache_dir, single_digit: bool) -> pathlib.Path:
    cache_dir = pathlib.Path(cache_dir) if cache_dir else _DATA_DIR
    return cache_dir / f"{'srmnist' if single_digit else 'rmnist'}_cache.npz"


def rmnist_dataset(
    scaling=True,
    single_digit=False,
    seed: int = 0,
    cache_dir=None,
    rots_train=None,
    rots_test=None,
):
    """(S)RMNIST regression dataset.

    SRMNIST (single_digit=True): 10 fixed digits x (1000 rotations + original)
    train / x 100 + original test -> 10,010 / 1,010 samples of 28x28, target =
    rotation angle; full RMNIST: 100 digits x 101 / x 11. Pixel scaling
    (x - 127.5)/255 as reference load_dataset.py:75-77.

    Uses real MNIST when a local file exists; otherwise the deterministic
    digits surrogate with identical shapes (``rmnist_is_real`` says which).
    A cache in ``cache_dir`` is served whatever ``seed``, ``rots_train`` and
    ``rots_test`` ask for (the JAX package's key).
    """
    cache = _cache_file(cache_dir, single_digit)
    if cache.exists():
        d = np.load(cache)
        out = {k: d[k] for k in d.files}
    else:
        loaded = _load_mnist_train()
        if loaded is not None:
            images, labels = loaded
            real = True
        else:
            images, labels = _surrogate_digits()
            real = False
        rng = np.random.default_rng(seed)
        if single_digit:
            if real:
                sel = np.array(_SRMNIST_DIGIT_IDX)
            else:
                # one exemplar per class, deterministic
                sel = np.array([np.flatnonzero(labels == c)[0] for c in range(10)])
            imgs, labs = images[sel], labels[sel]
            n, rtr, rte = len(sel), rots_train or 1000, rots_test or 100
        else:
            imgs, labs = images[:100], labels[:100]
            n, rtr, rte = 100, rots_train or 100, rots_test or 10
        tx, ty, tl = rotate_mnist(imgs, labs, n, rtr, rng)
        ex, ey, el = rotate_mnist(imgs, labs, n, rte, rng)
        out = dict(
            train_x=tx, train_y=ty, train_labels=tl,
            test_x=ex, test_y=ey, test_labels=el,
            real=np.array(real),
        )
        try:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache, **out)
        except OSError:
            pass
    sx, ex = out["train_x"], out["test_x"]
    if scaling:
        sx = (sx - 127.5) / 255.0
        ex = (ex - 127.5) / 255.0
    return (
        sx.reshape(sx.shape[0], -1).astype(np.float32),
        out["train_y"].astype(np.float32),
        out["train_labels"].astype(np.int32),
        ex.reshape(ex.shape[0], -1).astype(np.float32),
        out["test_y"].astype(np.float32),
        out["test_labels"].astype(np.int32),
    )


def rmnist_is_real(cache_dir=None, single_digit=True) -> bool:
    """Whether the (cached or would-be-built) RMNIST dataset uses real MNIST
    (a local mnist.npz via MNIST_NPZ / keras cache / data dir) rather than
    the digits surrogate: the flag the scripts key their pinned-row
    comparisons on. A cache without the flag predates it and was a
    surrogate build."""
    cache = _cache_file(cache_dir, single_digit)
    if cache.exists():
        d = np.load(cache)
        return bool(d["real"]) if "real" in d.files else False
    return _load_mnist_train() is not None
