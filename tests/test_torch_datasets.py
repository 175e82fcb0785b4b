"""Port vs JAX: the dataset loaders (``utils/datasets.py``) and the reference
protocols that read them, on the CPU.

  * Twins of tests/test_mnist_ingestion.py on the same synthetic
    keras-layout npz; the digits surrogate, ``rotate_mnist`` and a small
    SRMNIST/RMNIST build bit for bit; ``parse_stl`` (binary and ASCII) and
    ``parse_msh`` on small files written here; the dumbbell and dragon
    datasets and the port's copies of the meshes equal to the JAX
    package's. Every build passes its own ``cache_dir``: the cache key is
    only the variant, so a shared directory would serve one size to another.
  * The 1-D pretrained evaluation (``examples_torch/eval_pretrained.py``)
    against the JAX package's on JAX's kNN graph. Tolerances: the vanilla
    GP 1e-4 relative; IMGP RMSE and NLL 5e-3 relative. At the reference's
    noise / outputscale = 6e-5 each package's f32 metrics land ~1e-3 from
    the exact ones (port 9.6e-4, JAX 1.4e-3: the feature-space system's
    condition number is 7.3e4, the posterior covariance's 1.8e6). The f64
    witness removes that layer: with the host f64 basis and JAX's
    out-of-sample kNN choice, the features agree within 1e-5 of the largest
    and the posterior computed from them in f64 within 1e-5 relative; the
    port's own posterior code run in f64 on its features lands within 1e-7
    of its witness. On its own search the port keeps
    other edges only where the chain's neighbours tie.
  * A twin of tests/test_dragon_smoke.py (the ~830-node reduced protocol,
    dense, 5 epochs): the JAX test's bounds, and the loss trajectory held
    to JAX's within 1e-4 relative (shared graph and average-variance
    indices; the dense loss draws nothing).
  * Twins of tests/test_regressions.py's two bandwidth tests on every other
    dumbbell node: the JAX tests' bounds on the port's trained bandwidth.
"""

import json
import pathlib
import struct

import jax
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse fixture)
from manifold_gp_tpu.utils import datasets as jds
from manifold_gp_torch.utils import datasets as tds

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = json.loads((ROOT / "examples_torch" / "dataset_pins.json").read_text())
IMGP_RTOL, VANILLA_RTOL = 5e-3, 1e-4
WITNESS_RTOL = 1e-5  # f64 posterior from f32 features: 5.3e-7 was measured
MODEL_F64_RTOL = 1e-7  # the port's posterior code in f64 vs numpy: 3.0e-9 measured


def _assert_same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


@pytest.fixture()
def fake_mnist_npz(tmp_path, monkeypatch):
    """tests/test_mnist_ingestion.py's keras-layout mnist.npz: 25
    recognizable uint8 images."""
    rng = np.random.default_rng(42)
    n = 25
    x = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    for i in range(n):
        x[i, 0, 0] = i * 10
    y = rng.integers(0, 10, size=(n,)).astype(np.int64)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=x, y_train=y, x_test=x[:5], y_test=y[:5])
    monkeypatch.setenv("MNIST_NPZ", str(path))
    return path, x, y


@pytest.fixture()
def no_mnist(tmp_path, monkeypatch):
    """No MNIST anywhere the loaders look: the surrogate branch."""
    monkeypatch.setenv("MNIST_NPZ", "")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert tds._load_mnist_train() is None and jds._load_mnist_train() is None


def test_load_mnist_train_reads_npz(fake_mnist_npz):
    _, x, y = fake_mnist_npz
    loaded = tds._load_mnist_train()
    assert loaded is not None, "MNIST_NPZ branch must engage"
    np.testing.assert_array_equal(loaded[0], x)
    np.testing.assert_array_equal(loaded[1], y)
    _assert_same(loaded, jds._load_mnist_train())


def test_srmnist_real_branch_end_to_end(fake_mnist_npz, tmp_path):
    _, x, y = fake_mnist_npz
    rtr, rte = 4, 2
    kw = dict(scaling=True, single_digit=True, rots_train=rtr, rots_test=rte)
    out = tds.rmnist_dataset(cache_dir=tmp_path / "port", **kw)
    _assert_same(out, jds.rmnist_dataset(cache_dir=tmp_path / "jax", **kw))
    tx, ty, tl, ex, _, _ = out
    assert tx.shape == (10 * (rtr + 1), 784) and ex.shape == (10 * (rte + 1), 784)
    assert ty.shape == (10 * (rtr + 1),)
    per = rtr + 1
    assert tds._SRMNIST_DIGIT_IDX == jds._SRMNIST_DIGIT_IDX
    for slot, idx in enumerate(tds._SRMNIST_DIGIT_IDX):
        expected = ((x[idx].astype(np.float64) - 127.5) / 255.0).reshape(-1)
        np.testing.assert_allclose(tx[slot * per], expected.astype(np.float32), atol=1e-6)
        assert ty[slot * per] == 0.0 and tl[slot * per] == y[idx]
    rot_targets = np.delete(ty, np.arange(0, len(ty), per))
    assert np.all(np.abs(rot_targets) <= 45.0)
    assert np.count_nonzero(rot_targets) == rot_targets.size
    assert tx.min() >= -0.5 and tx.max() <= 0.5
    assert tds.rmnist_is_real(cache_dir=tmp_path / "port")


def test_srmnist_cache_roundtrip(fake_mnist_npz, tmp_path):
    cache = tmp_path / "cache2"
    a = tds.rmnist_dataset(single_digit=True, cache_dir=cache, rots_train=3, rots_test=1)
    assert (cache / "srmnist_cache.npz").exists()
    b = tds.rmnist_dataset(single_digit=True, cache_dir=cache, rots_train=3, rots_test=1)
    _assert_same(a, b)
    # the key is only the variant: another size is served the cached one
    c = tds.rmnist_dataset(single_digit=True, cache_dir=cache, rots_train=5, rots_test=2)
    _assert_same(a, c)


def test_surrogate_digits_bitwise():
    got = tds._surrogate_digits()
    assert got[0].shape == (1797, 28, 28) and got[0].dtype == np.uint8
    _assert_same(got, jds._surrogate_digits())


@pytest.mark.parametrize("shuffle", [False, True])
def test_rotate_mnist_bitwise(shuffle):
    images, labels = tds._surrogate_digits()
    sel = [0, 7, 40]
    args = (images[sel], labels[sel], 3, 4)
    got = tds.rotate_mnist(*args, rng=np.random.default_rng(5), shuffle=shuffle)
    _assert_same(got, jds.rotate_mnist(*args, rng=np.random.default_rng(5), shuffle=shuffle))


@pytest.mark.parametrize("single_digit,rots", [(True, (3, 1)), (False, (1, 1))])
def test_small_rmnist_surrogate_bitwise(no_mnist, tmp_path, single_digit, rots):
    kw = dict(single_digit=single_digit, rots_train=rots[0], rots_test=rots[1])
    out = tds.rmnist_dataset(cache_dir=tmp_path / "port", **kw)
    _assert_same(out, jds.rmnist_dataset(cache_dir=tmp_path / "jax", **kw))
    digits = 10 if single_digit else 100
    assert out[0].shape == (digits * (rots[0] + 1), 784)
    assert not tds.rmnist_is_real(cache_dir=tmp_path / "port", single_digit=single_digit)
    # unscaled pixels of the cached build: the same arrays again
    _assert_same(tds.rmnist_dataset(scaling=False, cache_dir=tmp_path / "port", **kw),
                 jds.rmnist_dataset(scaling=False, cache_dir=tmp_path / "jax", **kw))


# a tetrahedron: 4 vertices, 4 faces
_TET = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
_FACES = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)]


def _write_stl(path, ascii_format):
    if ascii_format:
        # both readers parse what follows the first 80 bytes (the binary
        # header's length), so the solid's name line fills them
        lines = ["solid tet".ljust(79)]
        for f in _FACES:
            lines += ["  facet normal 0 0 0", "    outer loop"]
            lines += [f"      vertex {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in _TET[list(f)]]
            lines += ["    endloop", "  endfacet"]
        lines.append("endsolid tet")
        path.write_text("\n".join(lines) + "\n")
    else:
        body = b"".join(
            struct.pack("<12fH", 0.0, 0.0, 0.0, *_TET[list(f)].reshape(-1), 0) for f in _FACES
        )
        path.write_bytes(b"binary tet".ljust(80, b" ") + struct.pack("<I", len(_FACES)) + body)


@pytest.mark.parametrize("ascii_format", [False, True], ids=["binary", "ascii"])
def test_parse_stl_matches_jax(tmp_path, ascii_format):
    path = tmp_path / "tet.stl"
    _write_stl(path, ascii_format)
    v, f = tds.parse_stl(path)
    _assert_same((v, f), jds.parse_stl(path))
    assert v.shape == (4, 3) and f.shape == (4, 3)
    np.testing.assert_array_equal(np.sort(v, axis=0), np.sort(_TET, axis=0))
    _assert_same(tds._unique_edges_from_faces(f)[None], jds._unique_edges_from_faces(f)[None])
    assert tds._unique_edges_from_faces(f).shape == (6, 2)
    # the dragon loader on this file: geodesic ground truth over its edges
    _assert_same(tds.manifold_2D_dataset(stl_path=path), jds.manifold_2D_dataset(stl_path=path))


def test_parse_msh_matches_jax(tmp_path):
    """A 6-node closed chain in gmsh's section layout (node: id x y z;
    line element: id type tags... n1 n2)."""
    t = np.linspace(0.0, 2 * np.pi, 6, endpoint=False)
    nodes = [f"{i + 1} {np.cos(a):.8f} {np.sin(a):.8f} 0" for i, a in enumerate(t)]
    elems = [f"{i + 1} 1 2 0 1 {i + 1} {(i + 1) % 6 + 1}" for i in range(6)]
    text = "\n".join(["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", *nodes,
                      "$EndNodes", "$Elements", *elems, "$EndElements"]) + "\n"
    path = tmp_path / "ring.msh"
    path.write_text(text)
    v, e = tds.parse_msh(path)
    _assert_same((v, e), jds.parse_msh(path))
    assert v.shape == (6, 2) and e.tolist()[0] == [0, 1] and e.tolist()[-1] == [5, 0]
    _assert_same(tds.manifold_1D_dataset(msh_path=path), jds.manifold_1D_dataset(msh_path=path))


@pytest.mark.parametrize("name", ["dumbbell.npz", "dragon.npz"])
def test_mesh_copies_match_jax(name):
    port = ROOT / "manifold_gp_torch" / "data" / name
    assert port.read_bytes() == (ROOT / "manifold_gp_tpu" / "data" / name).read_bytes()


def test_mesh_datasets_match_jax():
    x, y, e = tds.manifold_1D_dataset()
    assert x.shape == (1556, 2) and np.isfinite(y).all()
    _assert_same((x, y, e), jds.manifold_1D_dataset())
    x2, y2 = tds.manifold_2D_dataset()
    assert x2.shape == (4982, 3) and np.isfinite(y2).all()
    _assert_same((x2, y2), jds.manifold_2D_dataset())
    np.testing.assert_allclose(
        tds.geodesics_from_edges(x.astype(np.float64), e, source=7),
        jds.geodesics_from_edges(x.astype(np.float64), e, source=7), rtol=0, atol=0)


def test_digits_data_matches_sklearn_layout():
    """digits.npz holds load_digits' integers as uint8 (the cast back to
    float64 is exact) and the ten classes."""
    d = np.load(ROOT / "manifold_gp_torch" / "data" / "digits.npz")
    assert d["images"].shape == (1797, 8, 8) and d["images"].dtype == np.uint8
    assert d["images"].max() == 16 and d["target"].dtype == np.int64
    assert sorted(set(d["target"].tolist())) == list(range(10))


# ---------------------------------------------------------------------------
# The reference protocols
# ---------------------------------------------------------------------------


def test_pretrained_1d_matches_jax():
    from _dataset_pins import dumbbell_knn_idx, jax_pretrained_1d
    from examples_torch.eval_pretrained import run_experiment, tie_only_difference
    from manifold_gp_torch.ops.knn import knn_search

    idx = dumbbell_knn_idx()
    want = jax_pretrained_1d(seeds=0)
    got = run_experiment(device="cpu", seeds=2, knn_idx=idx)
    assert got["num_labeled"] == 10 and got["n"] == 1556
    for key in ("imgp_rmse", "imgp_nll", "imgp_nll_love"):
        np.testing.assert_allclose(got[key], want[key], rtol=IMGP_RTOL, err_msg=key)
    for key in ("vanilla_rmse", "vanilla_nll"):
        np.testing.assert_allclose(got[key], want[key], rtol=VANILLA_RTOL, err_msg=key)
    assert np.isfinite(got["imgp_nll_reference_metric"]["mean"])
    # the port's own search differs from JAX's only in tied neighbours
    x, _, _ = tds.manifold_1D_dataset()
    xt = torch.from_numpy(x)
    own = knn_search(xt, xt, 10, self_query=True)[1].numpy()
    assert tie_only_difference(x, own, idx)["ties_only"]
    np.testing.assert_array_equal(idx, np.asarray(PINS["dumbbell_pretrained"]["knn_idx"]))


def test_pretrained_1d_f64_witness_matches_jax():
    """The layer below the f32 solve: one basis (host f64 in both packages),
    one out-of-sample kNN choice (JAX's), the posterior in f64."""
    from _dataset_pins import jax_f64_witness
    from examples_torch.eval_pretrained import f64_witness, model_metrics_in_f64, run_experiment

    idx = np.asarray(PINS["dumbbell_pretrained"]["knn_idx"])
    want = jax_f64_witness(idx)
    handles = {}
    got_f32 = run_experiment(device="cpu", seeds=0, knn_idx=idx, eigensolver="host_f64",
                             handles=handles)
    with torch.no_grad():
        got = f64_witness(handles, idx, torch.as_tensor)
    assert np.abs(got["z"] - want["z"]).max() <= WITNESS_RTOL * np.abs(want["z"]).max()
    for key in ("rmse", "nll", "cond"):
        np.testing.assert_allclose(got[key], want[key], rtol=WITNESS_RTOL, err_msg=key)
    # the port's posterior and NLL code, in f64 on the same features
    own = model_metrics_in_f64(handles, got["z"])
    for key in ("rmse", "nll"):
        np.testing.assert_allclose(own[key], got[key], rtol=MODEL_F64_RTOL, err_msg=key)
    assert np.isfinite(got_f32["imgp_rmse"]) and np.isfinite(got_f32["imgp_nll"])


def test_dragon_reduced_training_matches_jax():
    """tests/test_dragon_smoke.py's protocol in both packages: the same
    graph (JAX's, handed to the port), the same average-variance indices
    (JAX's key chain replayed); the dense loss draws nothing."""
    import manifold_gp_tpu as J
    import manifold_gp_torch as T
    from manifold_gp_tpu.utils import manifold_informed_train as j_train
    from manifold_gp_tpu.utils import test_model as j_test_model
    from manifold_gp_torch.ops.graph import graph_from_edges
    from manifold_gp_torch.utils import manifold_informed_train, params_from_jax
    from manifold_gp_torch.utils import test_model as t_test_model

    x_all, y_all = tds.manifold_2D_dataset()
    x_all = x_all / (x_all.max(0) - x_all.min(0)).max()
    sub = np.arange(0, x_all.shape[0], 6)
    x, y = x_all[sub], y_all[sub]
    rng = np.random.default_rng(1337)
    test_idx = np.zeros(len(sub), bool)
    test_idx[rng.choice(len(sub), 60, replace=False)] = True
    train_x, test_x = x[~test_idx], x[test_idx]
    train_y, test_y = y[~test_idx], y[test_idx]
    train_y = train_y + 0.01 * rng.standard_normal(train_y.shape[0]).astype(np.float32)
    mu, sd = train_y.mean(), train_y.std(ddof=1)
    train_y, test_y = (train_y - mu) / sd, (test_y - mu) / sd

    kw = dict(nu=1, x=train_x, nearest_neighbors=10, laplacian_normalization="randomwalk",
              num_modes=50, bump_scale=10.0, bump_decay=1.0)
    cfg = dict(max_cholesky=2000, cg_tolerance=1e-2, cg_max_iter=500)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(**cfg), **kw)
    g = jk.graph
    live = np.asarray(g.mask) > 0
    tg = graph_from_edges(np.asarray(g.rows)[live], np.asarray(g.cols)[live],
                          np.asarray(g.sqdist)[live], g.num_nodes, device="cpu")
    tk = T.RiemannMaternKernel(cfg=T.InferenceConfig(**cfg), graph=tg, device="cpu", **kw)
    jm = J.RiemannGP(train_x, train_y, jk, cfg=jk.cfg)
    tm = T.RiemannGP(train_x, train_y, tk, cfg=tk.cfg)
    med = float(np.sqrt(np.median(np.asarray(g.sqdist)[live])))
    init = dict(noise=1e-2, outputscale=1.0, graphbandwidth=2.0 * med, lengthscale=1.0)

    epochs, num_rand_vec, n = 5, 100, train_x.shape[0]
    cb = jax.random.PRNGKey(0 + 7919)
    idx = {}
    for boundary in (0, epochs + 1):  # before the loop, after it
        cb, key = jax.random.split(cb)
        idx[boundary] = np.asarray(jax.random.randint(key, (num_rand_vec,), 0, n))
    train_kw = dict(lr=1e-1, max_iter=epochs, tolerance=0.0, num_rand_vec=num_rand_vec)
    jp, jloss, jhist = j_train(jm, jm.init_params(**init), **train_kw)
    tp0 = params_from_jax({k: np.asarray(v) for k, v in jm.init_params(**init).items()}, "cpu")
    tp, tloss, thist = manifold_informed_train(
        tm, tp0, idx_fn=lambda e: torch.tensor(idx[e]), **train_kw)

    # the JAX test's bounds
    assert np.isfinite(float(tloss))
    for k, v in tp.items():
        assert torch.isfinite(v).all(), k
    rmse, nll = t_test_model(tm, tp, test_x, test_y, noisy_test=True)
    assert np.isfinite(rmse) and np.isfinite(nll)
    assert rmse < 0.9, rmse
    # the trajectory: every epoch's loss and the final one
    assert len(thist) == len(jhist)
    np.testing.assert_allclose(thist, np.asarray(jhist), rtol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    jrmse, _ = j_test_model(jm, jp, test_x, test_y, noisy_test=True)
    np.testing.assert_allclose(rmse, jrmse, rtol=1e-3)


def test_run_rmnist_semisupervised_on_a_small_cache(no_mnist, tmp_path):
    """examples_torch/run_rmnist.py's control flow on the CPU: a small
    surrogate build served as the full one (the cache key is only the
    variant), one epoch, the result record the card's phase 11 reads."""
    from examples_torch.run_rmnist import dataset_fingerprint, run_experiment

    tds.rmnist_dataset(single_digit=True, cache_dir=tmp_path, rots_train=30, rots_test=2)
    handles = {}
    r = run_experiment("semisupervised", max_iter=1, device="cpu", handles=handles,
                       cache_dir=tmp_path)
    assert r["data"] == "surrogate-digits" and r["n"] == 310 and r["num_labeled"] == 31
    assert r["loss_evaluations"] == 2 and r["layout"] == "dense"
    assert set(r["phase_s"]) == {"dataset", "graph", "training", "vanilla", "basis", "eval"}
    for key in ("rmse_manifold", "nll_manifold", "rmse_vanilla", "nll_vanilla"):
        assert np.isfinite(r[key]), key
    assert r["train_launches"]["forward"] == 0  # CPU tensors: the plain version
    fp = dataset_fingerprint(*handles["dataset"])
    assert fp["train_x_shape"] == [310, 784] and len(fp["train_x_sha256"]) == 64


@pytest.fixture(scope="module")
def dumbbell_half():
    """tests/test_regressions.py's fixture: every other dumbbell node."""
    x, y, _ = tds.manifold_1D_dataset()
    sub = np.arange(0, x.shape[0], 2)
    x, y = x[sub], y[sub]
    rng = np.random.default_rng(1337)
    y = y + 0.01 * rng.standard_normal(y.shape[0]).astype(np.float32)
    return x, (y - y.mean()) / y.std()


def _train_bandwidth(x, y, gb_prior, gb_init, epochs=40):
    import manifold_gp_torch as T
    from manifold_gp_torch.utils import manifold_informed_train

    cfg = T.InferenceConfig(max_cholesky=2000)
    kernel = T.RiemannMaternKernel(
        nu=1, x=x, nearest_neighbors=10, laplacian_normalization="randomwalk", num_modes=50,
        bump_scale=10.0, bump_decay=1.0, graphbandwidth_prior=gb_prior, cfg=cfg, device="cpu",
    )
    model = T.RiemannGP(x, y, kernel, noise_constraint=T.GreaterThan(1e-8), cfg=cfg)
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=gb_init,
                               lengthscale=1.0)
    params, _, _ = manifold_informed_train(model, params, lr=1e-1, max_iter=epochs,
                                           tolerance=1e-2, num_rand_vec=100)
    return float(kernel.graphbandwidth(params).detach())


def test_graphbandwidth_collapse_without_prior(dumbbell_half):
    """The notebook init (eps = 1.0, no prior): the learnable-bandwidth
    objective collapses eps far below the median kNN distance."""
    from examples_torch.reference_protocol import knn_bandwidth

    x, y = dumbbell_half
    _, median = knn_bandwidth(x, "cpu")
    gb = _train_bandwidth(x, y, gb_prior=None, gb_init=1.0)
    jax_gb = PINS["dumbbell_bandwidth"]["no_prior"]
    print(f"bandwidth without prior: port {gb:.6g}, JAX {jax_gb:.6g} "
          f"(gap {gb / jax_gb - 1.0:+.3e}; median kNN distance {median:.6g})")
    assert gb < 0.75 * median, (gb, median)
    assert gb < 0.025 * 1.0


def test_graphbandwidth_stable_with_data_driven_prior(dumbbell_half):
    """The data-driven Gamma prior with a stable-basin init keeps eps at the
    median-kNN-distance scale."""
    from examples_torch.reference_protocol import bandwidth_prior, knn_bandwidth

    x, y = dumbbell_half
    gb_min, median = knn_bandwidth(x, "cpu")
    gb = _train_bandwidth(x, y, gb_prior=bandwidth_prior(gb_min, median),
                          gb_init=3.5 * median)
    jax_gb = PINS["dumbbell_bandwidth"]["prior"]
    print(f"bandwidth with the prior: port {gb:.6g}, JAX {jax_gb:.6g} "
          f"(gap {gb / jax_gb - 1.0:+.3e}; median kNN distance {median:.6g})")
    assert 0.75 * median < gb < 10.0 * median, (gb, median)
