"""Port vs JAX: multi-start training (``utils/multistart.py``, twin of
``tests/test_multistart.py``) on that test's model (the 160-point circle,
k = 6, nu = 1, the exact Cholesky loss below max_cholesky = 500, so no
probes are drawn): one restart lands where single-run training does, the
best of two basins is the argmin, random restarts are distinct; and from
the same two inits the port's final losses are JAX's and its best basin is
JAX's."""

import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from manifold_gp_tpu.utils.multistart import multi_start_train as j_multi_start_train
from manifold_gp_torch.utils import manifold_informed_train, params_to_numpy
from manifold_gp_torch.utils.multistart import multi_start_train, random_restarts

BASINS = [dict(noise=1e-2, outputscale=1.0, graphbandwidth=5.0, lengthscale=0.2),
          dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=1.0)]


def _model(pkg, **kw):
    x, y = small_cloud()
    cfg = pkg.InferenceConfig(max_cholesky=500)
    kernel = pkg.RiemannMaternKernel(nu=1, x=x, nearest_neighbors=6,
                                     laplacian_normalization="randomwalk", num_modes=10,
                                     cfg=cfg, **kw)
    return pkg.RiemannGP(x, y, kernel, cfg=cfg)


@pytest.fixture(scope="module")
def model():
    return _model(T, device="cpu")


def test_multi_start_matches_single_run(model):
    init = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=0.35, lengthscale=1.0)
    single, loss_single, _ = manifold_informed_train(
        model, {k: v.clone() for k, v in init.items()}, lr=1e-1, max_iter=10, tolerance=0.0,
        seed=0)
    stacked, losses = multi_start_train(model, [init], lr=1e-1, max_iter=10, seed=0,
                                        return_all=True)
    one = {k: v[0] for k, v in stacked.items()}
    np.testing.assert_allclose(float(losses[0]), loss_single, atol=0.02)
    single = params_to_numpy(single)
    for k in single:
        if k == "raw_outputscale":
            # multi_start_train skips the outputscale normalization protocol
            continue
        np.testing.assert_allclose(one[k].numpy(), single[k], rtol=0.15, atol=0.05)
    # the inits are not modified
    assert float(model.kernel.graphbandwidth(init)) == pytest.approx(0.35, rel=1e-6)


def test_multi_start_picks_best_basin(model):
    inits = [model.init_params(**b) for b in BASINS]
    best, best_loss, losses = multi_start_train(model, inits, lr=1e-1, max_iter=15)
    assert best_loss == float(np.min(losses.numpy()))
    assert tuple(losses.shape) == (2,)
    # JAX's vmapped restarts from the same inits: the same final losses (the
    # exact loss draws nothing) and the same best basin
    jm = _model(J)
    jbest, jbest_loss, jlosses = j_multi_start_train(jm, [jm.init_params(**b) for b in BASINS],
                                                     lr=1e-1, max_iter=15)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=1e-5)
    assert int(np.argmin(losses.numpy())) == int(np.argmin(np.asarray(jlosses)))
    got = params_to_numpy(best)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(jbest[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_random_restarts_shapes(model):
    inits = random_restarts(model, 0, 3)
    assert len(inits) == 3
    gbs = [float(model.kernel.graphbandwidth(p)) for p in inits]
    assert len(set(gbs)) == 3  # distinct draws
    assert all(1e-2 <= g <= 1.0 for g in gbs)
    again = random_restarts(model, torch.Generator().manual_seed(0), 3)
    assert [float(model.kernel.graphbandwidth(p)) for p in again] == gbs
