"""Port vs JAX: ``tests/test_eval_basis_large.py`` — ``eval_basis`` above
``eigh_max_size`` on block-ELL panels (the config default, LOBPCG) against
the dense-eigh route on the same 600-point ring, for f32 and bf16
``spmv_dtype``: the basis assembles f32 panels whatever ``spmv_dtype`` is,
so the bf16 configuration gives the f32 basis bit for bit. The JAX test's
tolerances, and the eigenvalues against JAX's dense route."""

import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
import manifold_gp_torch as T


def _ring():
    rng = np.random.default_rng(20240817)
    t = np.sort(rng.uniform(0, 2 * np.pi, 600))
    x = np.stack([np.cos(t), np.sin(t)], 1).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    return x


KW = dict(nu=2, nearest_neighbors=8, laplacian_normalization="randomwalk", num_modes=8)


def _basis(x, **cfg_kw):
    k = T.RiemannMaternKernel(x=x, cfg=T.InferenceConfig(**cfg_kw), device="cpu", **KW)
    val, vec = k.eval_basis(k.init_params(graphbandwidth=0.5, lengthscale=1.0))
    return k, val.numpy(), vec.numpy()


@pytest.fixture(scope="module")
def dense_bases():
    x = _ring()
    _, val_d, vec_d = _basis(x)
    jk = J.RiemannMaternKernel(x=x, cfg=J.InferenceConfig(), **KW)
    jval, _ = jk.eval_basis(jk.init_params(graphbandwidth=0.5, lengthscale=1.0))
    return x, val_d, vec_d, np.asarray(jval)


@pytest.mark.parametrize("spmv_dtype", ["float32", "bfloat16"])
def test_lanczos_block_basis_matches_dense(spmv_dtype, dense_bases):
    x, val_d, vec_d, jval_d = dense_bases
    k_lan, val_l, vec_l = _basis(x, eigh_max_size=0, dense_operator_max_size=0,
                                 spmv_dtype=spmv_dtype)
    assert k_lan.block_layout is not None
    tol = 5e-3
    np.testing.assert_allclose(val_l, val_d, rtol=tol, atol=tol * 0.1)
    np.testing.assert_allclose(val_l, jval_d, rtol=tol, atol=tol * 0.1)
    np.testing.assert_allclose(val_d, jval_d, rtol=1e-5, atol=1e-6)
    for j in range(6):
        gap = min(abs(val_d[j] - val_d[j - 1]) if j > 0 else 1.0, abs(val_d[j + 1] - val_d[j]))
        if gap < 1e-3:
            continue  # degenerate pair: any basis rotation is valid
        dot = abs(float(vec_l[:, j] @ vec_d[:, j]))
        assert dot > 0.98, (j, dot)
    if spmv_dtype == "bfloat16":
        # the same start block and f32 panels: the f32 configuration's basis
        _, val_32, vec_32 = _basis(x, eigh_max_size=0, dense_operator_max_size=0)
        assert val_l.tobytes() == val_32.tobytes()
        assert vec_l.tobytes() == vec_32.tobytes()
