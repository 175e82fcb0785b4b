"""Port vs JAX: the keyed graph / basis cache (``utils/cache.py``, twin of
``tests/test_cache.py``): hits, eviction by key, corrupt-entry eviction,
cached vs fresh equality; the port's keys equal JAX's byte for byte, and an
entry written by either package loads in the other to the same edges."""

import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
from manifold_gp_tpu.ops.graph import build_graph as j_build_graph
from manifold_gp_tpu.utils import cache as jcache
from manifold_gp_tpu.utils import checkpoint as jckpt
from manifold_gp_torch.config import InferenceConfig
from manifold_gp_torch.kernels import RiemannMaternKernel
from manifold_gp_torch.ops.graph import build_graph
from manifold_gp_torch.utils import checkpoint as tckpt
from manifold_gp_torch.utils.cache import (
    basis_cache_key,
    cached_eval_basis,
    cached_graph,
    clear_cache,
    graph_cache_key,
)


@pytest.fixture()
def cloud():
    rng = np.random.default_rng(300)
    n = 300
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], 1)
    x += 0.01 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def _edges(g):
    return [np.asarray(a) for a in (g.rows, g.cols, g.sqdist)]


def test_graph_cache_hit_and_equality(cloud, tmp_path):
    calls = []

    def builder():
        calls.append(1)
        return build_graph(cloud, 8, device="cpu")

    g1, hit1 = cached_graph(cloud, 8, str(tmp_path), builder=builder, device="cpu")
    g2, hit2 = cached_graph(cloud, 8, str(tmp_path), builder=builder, device="cpu")
    assert (hit1, hit2) == (False, True)
    assert len(calls) == 1, "second call must load, not rebuild"
    for a, b in zip(_edges(g1), _edges(g2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g1.ell_col.numpy(), g2.ell_col.numpy())
    assert g1.max_degree == g2.max_degree


def test_graph_cache_evicts_on_mismatch(cloud, tmp_path):
    g1, _ = cached_graph(cloud, 8, str(tmp_path), device="cpu")
    g2, hit = cached_graph(cloud, 6, str(tmp_path), device="cpu")
    assert not hit
    assert g2.num_edges != g1.num_edges
    _, hit = cached_graph(cloud + 0.5, 8, str(tmp_path), device="cpu")
    assert not hit
    _, hit = cached_graph(cloud, 8, str(tmp_path), device="cpu")
    assert hit
    assert clear_cache(str(tmp_path)) == 3
    _, hit = cached_graph(cloud, 8, str(tmp_path), device="cpu")
    assert not hit


def test_graph_cache_corrupt_entry_evicted(cloud, tmp_path):
    cached_graph(cloud, 8, str(tmp_path), device="cpu")
    key = graph_cache_key(cloud, 8, "device")
    p = tmp_path / f"graph_{key}.npz"
    p.write_bytes(b"garbage")
    g, hit = cached_graph(cloud, 8, str(tmp_path), device="cpu")
    assert not hit  # corrupt entry evicted and rebuilt
    g2, hit = cached_graph(cloud, 8, str(tmp_path), device="cpu")
    assert hit
    np.testing.assert_array_equal(g.rows.numpy(), g2.rows.numpy())


def test_basis_cache_hit_and_bandwidth_eviction(cloud, tmp_path):
    kernel = RiemannMaternKernel(nu=2, x=cloud, nearest_neighbors=6,
                                 laplacian_normalization="randomwalk", num_modes=8,
                                 cfg=InferenceConfig(), device="cpu")
    params = kernel.init_params(graphbandwidth=0.3, lengthscale=1.0)
    (val1, vec1), hit1 = cached_eval_basis(kernel, params, str(tmp_path))
    (val2, vec2), hit2 = cached_eval_basis(kernel, params, str(tmp_path))
    assert (hit1, hit2) == (False, True)
    np.testing.assert_array_equal(val1.numpy(), val2.numpy())
    np.testing.assert_array_equal(vec1.numpy(), vec2.numpy())
    fval, fvec = kernel.eval_basis(params)
    np.testing.assert_allclose(val2.numpy(), fval.numpy(), atol=1e-6)
    np.testing.assert_allclose(vec2.numpy(), fvec.numpy(), atol=1e-6)
    params2 = kernel.init_params(graphbandwidth=0.4, lengthscale=1.0)
    _, hit3 = cached_eval_basis(kernel, params2, str(tmp_path))
    assert not hit3


def test_cache_keys_equal_jax(cloud):
    """The same inputs give JAX's graph and basis keys byte for byte (the
    same hashed bytes and config string)."""
    for k, backend in ((8, "device"), (6, "host"), (16, "ivf-nlist2048-nprobe16-it5")):
        assert graph_cache_key(cloud, k, backend) == jcache.graph_cache_key(cloud, k, backend)
    assert graph_cache_key(torch.from_numpy(cloud), 8) == jcache.graph_cache_key(cloud, 8)
    kw = dict(nu=2, x=cloud, nearest_neighbors=6, laplacian_normalization="randomwalk",
              num_modes=8)
    jk = J.RiemannMaternKernel(cfg=J.InferenceConfig(eigensolver="chebyshev"), **kw)
    tk = RiemannMaternKernel(cfg=InferenceConfig(eigensolver="chebyshev"), device="cpu", **kw)
    for a, b in zip(_edges(tk.graph), _edges(jk.graph)):
        np.testing.assert_array_equal(a, b)
    # one f32 bandwidth value for both (each package's softplus round trip of
    # 0.3 lands on its own last bit: f32 log / expm1 differ by an ulp)
    gb = np.float32(jk.graphbandwidth(jk.init_params(graphbandwidth=0.3)))
    assert basis_cache_key(tk, torch.tensor(gb)) == jcache.basis_cache_key(jk, gb)
    assert basis_cache_key(tk, torch.tensor(gb)) != basis_cache_key(tk, torch.tensor(gb + 1e-6))


def test_cache_entries_load_across_packages(cloud, tmp_path):
    """A graph entry JAX writes loads in the port to JAX's edges, and one the
    port writes loads in JAX; the same for ``save_graph_cache``."""
    jg, hit = jcache.cached_graph(cloud, 8, str(tmp_path / "j"))
    assert not hit
    tg, hit = cached_graph(cloud, 8, str(tmp_path / "j"), device="cpu",
                           builder=lambda: pytest.fail("the JAX entry was not loaded"))
    assert hit
    for a, b in zip(_edges(tg), _edges(jg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.ell_col.numpy(), np.asarray(jg.ell_col))
    tg2, _ = cached_graph(cloud + 1.0, 8, str(tmp_path / "t"), device="cpu")
    jg2, hit = jcache.cached_graph(cloud + 1.0, 8, str(tmp_path / "t"),
                                   builder=lambda: pytest.fail("the port's entry was not loaded"))
    assert hit
    for a, b in zip(_edges(tg2), _edges(jg2)):
        np.testing.assert_array_equal(a, b)

    fp = tckpt.array_fingerprint(cloud)
    assert fp == jckpt.array_fingerprint(cloud)
    jckpt.save_graph_cache(j_build_graph(cloud, 8), tmp_path / "fp", fp)
    loaded = tckpt.load_graph_cache(tmp_path / "fp", fp, device="cpu")
    assert loaded.rows.dtype == torch.int64 and loaded.ell_edge.dtype == torch.int64
    for name in ("rows", "cols", "sqdist", "ell_edge", "ell_col", "ell_mask"):
        np.testing.assert_array_equal(getattr(loaded, name).numpy(), getattr(tg, name).numpy())
    assert (loaded.num_nodes, loaded.max_degree) == (tg.num_nodes, tg.max_degree)
    tckpt.save_graph_cache(tg, tmp_path / "fp2", fp)
    back = jckpt.load_graph_cache(tmp_path / "fp2", fp)
    np.testing.assert_array_equal(np.asarray(back.ell_edge), tg.ell_edge.numpy())
    assert tckpt.load_graph_cache(tmp_path / "fp", "0" * 16, device="cpu") is None
