"""Preconditioned CG in the port: the same solutions and gradients, fewer
iterations (twin of tests/test_precondition.py).

The Jacobi diagonal is exact against the densified precision for nu = 1, 2;
Jacobi cuts CG iterations where the density-corrected degree spreads; the
implicit CG gradient does not depend on the preconditioner; and no
preconditioner the model builds (Jacobi or pivoted Cholesky) moves
``mll_loss`` or its gradients, only the iteration paths of its solves. The
reference's model case is semisupervised; its twin is in
tests/test_torch_schur.py. This one holds the supervised loss to the same
bounds, and adds the pivoted-Cholesky case.
"""

import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread, small_cloud  # noqa: F401  (autouse fixture)
import manifold_gp_torch as T
from manifold_gp_torch.ops.cg import cg_raw, cg_solve
from manifold_gp_torch.ops.graph import build_graph
from manifold_gp_torch.ops.laplacian import laplacian_coeffs
from manifold_gp_torch.ops.matern import (
    make_jacobi_precond,
    make_matern_precision_matvec,
    matern_precision_diag,
)


@pytest.fixture(scope="module")
def ill_conditioned():
    """nu = 3, small-epsilon Matérn precision on clustered data: the
    density-corrected degree spans ~2 orders of magnitude across cluster
    cores and gaps, so diag(Q) spreads and Jacobi has work to do."""
    rng = np.random.default_rng(1337)
    n = 600
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3
    x = centers[rng.integers(0, 4, n)] + 0.25 * rng.standard_normal((n, 8)).astype(np.float32)
    graph = build_graph(x, 10, device="cpu")
    coeffs = laplacian_coeffs(graph, 0.15)
    mv = make_matern_precision_matvec(graph, coeffs, 3, 1.0, "randomwalk")
    diag = matern_precision_diag(graph, coeffs, 3, 1.0, "randomwalk")
    b = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    return graph, mv, diag, b


def test_jacobi_reduces_iterations(ill_conditioned):
    _, mv, diag, b = ill_conditioned
    tol, max_iter = 1e-4, 4000
    x_plain, it_plain = cg_raw(mv, b, tol, max_iter, with_info=True)
    x_pcg, it_pcg = cg_raw(mv, b, tol, max_iter, precond=make_jacobi_precond(diag),
                           with_info=True)
    scale = float(x_plain.abs().max())
    np.testing.assert_allclose(x_pcg.numpy(), x_plain.numpy(), atol=2 * tol * scale)
    assert it_pcg < 0.8 * it_plain, (it_pcg, it_plain)
    assert it_plain < max_iter, "plain CG must converge for a fair comparison"


def test_precision_diag_exact_nu12():
    """matern_precision_diag is exact for nu in {1, 2} against the densified Q."""
    rng = np.random.default_rng(5)
    n = 120
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], axis=1).astype(np.float32)
    graph = build_graph(x, 6, device="cpu")
    coeffs = laplacian_coeffs(graph, 0.3)
    for nu in (1, 2):
        for norm in ("symmetric", "randomwalk"):
            dense = make_matern_precision_matvec(graph, coeffs, nu, 0.7, norm)(torch.eye(n))
            d = matern_precision_diag(graph, coeffs, nu, 0.7, norm)
            np.testing.assert_allclose(d.numpy(), torch.diagonal(dense).numpy(), rtol=2e-5,
                                       atol=1e-5)


def test_cg_solve_precond_gradients_match(ill_conditioned):
    """The implicit-function backward does not depend on the preconditioner:
    a solve-based loss has the same value and gradient with and without
    Jacobi."""
    graph, _, _, b = ill_conditioned

    def loss(precondition):
        eps = torch.tensor(0.05, requires_grad=True)
        coeffs = laplacian_coeffs(graph, eps)
        mv = make_matern_precision_matvec(graph, coeffs, 2, 1.0, "randomwalk")
        pc = (make_jacobi_precond(matern_precision_diag(graph, coeffs, 2, 1.0, "randomwalk")
                                  .detach()) if precondition else None)
        value = torch.sum(cg_solve(mv, b, tol=1e-6, max_iter=4000, precond=pc) * b)
        (grad,) = torch.autograd.grad(value, eps)
        return float(value.detach()), float(grad)

    v0, g0 = loss(False)
    v1, g1 = loss(True)
    np.testing.assert_allclose(v1, v0, rtol=1e-4)
    np.testing.assert_allclose(g1, g0, rtol=1e-3)


@pytest.mark.parametrize("precond_type", ["jacobi", "pivchol"])
def test_model_loss_same_with_precondition(precond_type):
    """cfg.cg_precondition and the preconditioner it selects do not change
    mll_loss values or gradients (same probes), only the CG iteration
    paths."""
    x, y = small_cloud()

    def loss_and_grads(**cfg_kw):
        cfg = T.InferenceConfig(max_cholesky=0, num_probes=32, cg_tolerance=1e-5,
                                cg_max_iter=2000, **cfg_kw)
        kernel = T.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=6,
                                       laplacian_normalization="randomwalk", num_modes=10,
                                       cfg=cfg, device="cpu")
        model = T.RiemannGP(x, y, kernel, cfg=cfg)
        params = {k: v.requires_grad_(True) for k, v in model.init_params(
            noise=1e-3, outputscale=1.0, graphbandwidth=0.3, lengthscale=1.0).items()}
        loss = model.mll_loss(params, generator=torch.Generator().manual_seed(7))
        names = [k for k in params if k != "mean_constant"]
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return float(loss.detach()), {k: float(g) for k, g in zip(names, grads)}

    v0, g0 = loss_and_grads(cg_precondition=False)
    v1, g1 = loss_and_grads(precond_type=precond_type)
    np.testing.assert_allclose(v1, v0, rtol=1e-3)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=2e-2, atol=1e-4)
