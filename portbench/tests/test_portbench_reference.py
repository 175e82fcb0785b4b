"""The plain reference agrees with the port's CPU path on a small torus and
a small curve: the graph, the noisy precision's apply, the loss on shared
probes, the outputscale normalization, the posterior from one basis, and
the reference's own basis with a dense eigendecomposition."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _small import small_cell

from portbench.harness import check, program
from portbench.loops import train_jobs
from portbench.reference import eigen as ref_eigen
from portbench.reference import operator as ref_op
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train

CPU = torch.device("cpu")


def build(name: str, n: int):
    """The port's model of the small cell, in f32 panels, and the
    reference's set-up from the same inputs."""
    cell = small_cell(name, n=n)
    config = dict(cell.config, inference=dict(cell.config["inference"], spmv_dtype="float32"))
    torch.manual_seed(0)
    model, inputs = program.build(config, 11, CPU, {})
    ref = check.reference_setup(inputs.train_x_raw, config["k"], CPU)
    return config, model, inputs, ref


@pytest.mark.parametrize("name", ["torus262k-train", "curve262k-train"])
def test_graph_and_precision_apply(name):
    config, model, inputs, ref = build(name, 1500)
    g = model.kernel.graph
    assert check.edges_off(ref, g.rows.numpy(), g.cols.numpy()) == 0.0
    assert inputs.eps == pytest.approx(ref.eps, rel=1e-6)
    assert inputs.gb_floor == pytest.approx(ref.gb_floor, rel=1e-5)
    params = model.init_params(**config["hypers"])
    v = torch.randn(model.num_data, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port = model.precision_matvec(params)(v).double()
    raw = {k: p.double() for k, p in params.items()}
    ours = ref_op.Precision(ref.graph, raw, ref.gb_floor, config["nu"], "f32")(v.double())
    assert torch.max(torch.abs(port - ours)) / torch.max(torch.abs(ours)) < 1e-5


@pytest.mark.parametrize("name", ["torus262k-train", "curve262k-train"])
def test_loss_and_normalization(name):
    config, model, inputs, ref = build(name, 1500)
    feed = train_jobs.TrainFeed(5, 0, model.num_data, model.cfg.num_probes, 100, CPU)
    params = model.init_params(**config["hypers"])
    problem = ref_train.Problem(ref.graph, torch.as_tensor(inputs.train_y, dtype=torch.float64),
                                ref.gb_floor, config["nu"], config["inference"], "f32")
    raw = {k: p.double() for k, p in params.items()}
    with torch.no_grad():
        port = float(model.mll_loss(params, probes=feed.probes(0)))
    assert abs(port - problem.loss(raw, feed.probes(0).double())) < 1e-4
    with torch.no_grad():
        avg = float(model.average_variance(params, num_rand_vec=100, idx=feed.indices(0)))
    ref_avg = float(problem.average_variance(raw, feed.indices(0)))
    # the port solves to its configured 1e-2, the reference ten thousand times tighter
    assert avg == pytest.approx(ref_avg, rel=1e-2)


def test_posterior_from_one_basis():
    config, model, inputs, ref = build("torus262k-serve", 2000)
    params = model.init_params(**config["hypers"])
    model.eval(params)
    basis = model.kernel.eval_basis(params)
    post = model.posterior(params, torch.as_tensor(inputs.test_x))
    raw = ref_op.raw_from_values(config["hypers"], ref.gb_floor)
    vals = ref_op.values(raw, ref.gb_floor)
    coeffs = ref_op.Coeffs(ref.graph, vals["graphbandwidth"])
    xs = torch.as_tensor(inputs.train_x_raw, dtype=torch.float64) / ref.eps
    ts = torch.as_tensor(inputs.test_x_raw, dtype=torch.float64) / ref.eps
    nbrs = ref_serve.neighbours(xs, ts, config["k"])
    _, idx = model.kernel.knn.search(torch.as_tensor(inputs.test_x), config["k"],
                                     self_query=False)
    assert torch.equal(torch.sort(idx.long(), dim=1).values, torch.sort(nbrs[1], dim=1).values)
    mean, var = ref_serve.posterior(
        coeffs, nbrs, torch.as_tensor(inputs.train_y, dtype=torch.float64),
        basis[0].double(), basis[1].double(), vals, config["nu"],
        config["bump_scale"], config["bump_decay"])
    np.testing.assert_allclose(post.mean.double(), mean, atol=1e-5 * float(mean.abs().max()))
    np.testing.assert_allclose(torch.diagonal(post.covar).double(), var,
                               atol=1e-5 * float(var.max()))
    resid = ref_serve.basis_residuals(coeffs, basis[0].double(), basis[1].double())
    assert float(torch.median(resid)) < 1e-4


@pytest.mark.parametrize("manifold", ["torus", "curve"])
def test_own_basis_equals_dense_eigh(manifold):
    """The reference's Chebyshev-filtered subspace iteration gives the
    lowest modes of its Laplacian as a dense eigendecomposition does, in the
    served form (the lowest eigenvalue 0, vectors D^-1/2 u normalized)."""
    name = "torus262k-serve" if manifold == "torus" else "curve262k-train"
    cell = small_cell(name, n=1500)
    config = cell.config
    from portbench.harness import data

    train_x = data.campaign_data(1500, 128, 0, manifold)[0]
    ref = check.reference_setup(train_x, config["k"], CPU)
    vals = ref_op.values(ref_op.raw_from_values(config["hypers"], ref.gb_floor), ref.gb_floor)
    coeffs = ref_op.Coeffs(ref.graph, vals["graphbandwidth"])
    m = 20
    own = ref_eigen.lowest(coeffs, torch.as_tensor(train_x, dtype=torch.float64) / ref.eps, m, 3)
    g = ref.graph
    dense = torch.diag(coeffs.diag)
    dense[g.rows, g.cols] -= coeffs.off
    dense[g.cols, g.rows] -= coeffs.off
    lam = torch.linalg.eigvalsh(dense)[:m]
    assert float(own["resid"].max()) < 1e-8
    assert float(torch.max(torch.abs(own["eigval"][1:] - lam[1:]) / lam[1:])) < 1e-8
    assert float(lam[0]) < 1e-12 and float(own["eigval"][0]) == 0.0
    assert float(torch.max(ref_serve.basis_residuals(coeffs, own["eigval"], own["eigvec"]))) < 1e-8
    assert ref_serve.orthonormality_gap(coeffs, own["eigvec"]) < 1e-10
