"""The float64 Schur reference (``portbench/reference/semisup.py``) and the
port's semi-supervised path, on the CPU.

At 300 nodes the reference's apply of S, its SLQ log-det and its gradient
(the hatted identity a' dS b = a^' dQ b^, no differentiation through a
solve) equal dense float64 algebra and autograd, and its loss stops its
inner solves at the tolerance asked for. At 1,024 torus points the port's
semi-supervised loss and gradient (``RiemannGP(labeled=...)``, the
block-ELL operator on the plain kernel versions, f32 and bf16 panels) equal
the reference's on the same probes. Under tracing, the Schur counters agree
with ``ops.cg.iteration_log``. The benchmark's configuration of the cell:
its labeled mask is fixed, and it is the torus configuration plus the mask.
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from manifold_gp_torch.ops import cg
from manifold_gp_torch.utils import metrics
from portbench.harness import check, data, program, spec
from portbench.loops import semisup_jobs
from portbench.reference import operator as ref_op
from portbench.reference import semisup as ref_semisup
from portbench.reference import train as ref_train

CPU = torch.device("cpu")
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "portbench" / "configs"
RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")


@pytest.fixture(scope="module")
def dense_case():
    """300 torus nodes, 40 labeled, the torus campaign's trained values:
    the reference's problem (solves to 1e-10) and the dense kernel
    precision as a function of the raw parameters."""
    config = json.loads((CONFIGS / "torus262k.json").read_text())
    x = data.campaign_data(308, 8, 0, "torus")[0]
    ref = check.reference_setup(x, config["k"], CPU)
    n = ref.graph.n
    rng = np.random.default_rng(3)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 40, replace=False)] = True
    y = torch.as_tensor(rng.standard_normal(40))
    inference = dict(config["inference"], cg_tolerance=1e-9)
    problem = ref_semisup.SemisupProblem(ref.graph, y, torch.as_tensor(mask), ref.gb_floor,
                                         config["nu"], inference)
    raw = ref_op.raw_from_values(config["hypers"], ref.gb_floor)
    probes = torch.as_tensor(rng.choice([-1.0, 1.0], size=(40, 6)))

    def dense(leaves):
        """(dense Q, dense S, values) at ``leaves``, differentiable."""
        prec = ref_op.Precision(ref.graph, leaves, ref.gb_floor, config["nu"],
                                differentiable=True)
        q = prec.kernel_q(torch.eye(n, dtype=torch.float64))
        li, ui = problem.li, problem.ui
        s = q[li][:, li] - q[li][:, ui] @ torch.linalg.solve(q[ui][:, ui], q[ui][:, li])
        return q, s, ref_op.values(leaves, ref.gb_floor)

    return problem, raw, probes, dense


def _noisy(s, vals):
    ss = vals["outputscale"] * s
    return ss - vals["noise"] * ss @ ss + vals["noise"] ** 2 * ss @ ss @ ss


def test_reference_schur_apply_equals_dense(dense_case):
    problem, raw, _, dense = dense_case
    _, s, _ = dense(raw)
    sch = problem.schur(problem.op(raw))
    v = torch.randn(40, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    sv, vh = sch.apply(v)
    # inner CG to 1e-10: the apply equals the dense Schur complement to ~1e-10
    assert float(torch.max(torch.abs(sv - s @ v)) / torch.max(torch.abs(s @ v))) < 1e-8
    assert torch.equal(vh[problem.li], v)


def test_reference_loss_follows_its_inner_tolerance(dense_case):
    """The loss's inner solves stop at the tolerance asked for (the
    configuration's by default), and a loss kept for one tolerance is never
    handed out for another."""
    problem, raw, probes, _ = dense_case
    loose = problem.loss(raw, probes, tol=0.3)
    tight = problem.loss(raw, probes)
    assert abs(loose - tight) > 1e-6
    assert problem.loss(raw, probes, tol=0.3) == loose
    assert problem.loss(raw, probes, tol=problem.loss_tol) == tight


def test_reference_slq_logdet_equals_dense(dense_case):
    """With as many Lanczos steps as labeled nodes the quadrature is exact:
    the SLQ estimate equals the probes' Hutchinson estimate of the dense
    log-det, (1 / p) sum_i z_i' log(P) z_i."""
    problem, raw, probes, dense = dense_case
    _, s, vals = dense(raw)
    lam, vec = torch.linalg.eigh(_noisy(s, vals).detach())
    logm = vec @ torch.diag(torch.log(lam)) @ vec.T
    want = torch.sum(probes * (logm @ probes)) / probes.shape[1]
    got = ref_train.slq_logdet(problem.noisy(problem.schur(problem.op(raw))), probes, 40)
    assert float(got) == pytest.approx(float(want), rel=1e-8)


def test_reference_gradient_equals_dense_autograd(dense_case):
    """The hatted gradient equals autograd through dense S of the same
    estimator: 0.5 / n (y' P y - (1 / p) sum_i (P^-1 z_i)' P z_i) with the
    solves held fixed. Differentiating (Q b^)_l with b^ held fixed, the
    pitfall of autograd through one hatted apply, gives half of dS's
    correction only, and misses by far more."""
    problem, raw, probes, dense = dense_case
    loss, grads = problem.loss_and_grad(raw, probes)
    leaves = {k: v.clone().requires_grad_(k != "mean_constant") for k, v in raw.items()}
    q, s, vals = dense(leaves)
    p = _noisy(s, vals)
    y = problem.y
    u = torch.linalg.solve(p.detach(), probes)
    n = y.shape[0]
    est = 0.5 / n * (y @ p @ y - torch.sum(u * (p @ probes)) / probes.shape[1])
    want = torch.autograd.grad(est, [leaves[k] for k in RAW], retain_graph=True)
    for k, w in zip(RAW, want):
        assert float(grads[k]) == pytest.approx(float(w), rel=1e-7), k
    # the pitfall: S b ~ (Q b^)_l with b^ fixed, differentiated through Q
    li = problem.li
    with torch.no_grad():
        sch = problem.schur(problem.op(raw))
        yh = sch.hat(y[:, None])[:, 0]
    half = 0.5 / n * vals["outputscale"] * (y @ (q @ yh)[li])
    full = 0.5 / n * vals["outputscale"] * (y @ s @ y)
    g_half = torch.autograd.grad(half, leaves["raw_lengthscale"], retain_graph=True)[0]
    g_full = torch.autograd.grad(full, leaves["raw_lengthscale"])[0]
    assert abs(float(g_half - g_full)) > 1e-3 * abs(float(g_full))
    assert math.isfinite(loss)


def _semisup(spmv_dtype: str, tol: float, num_probes: int = 4, steps: int = 8, n: int = 1024,
             **inference):
    """The port's semi-supervised model of the benchmark's cell at ``n``
    points (block-ELL, plain kernel versions) and the reference's setting
    from the same inputs, in the stated precision; ``inference`` overrides
    more of the configuration's inference settings."""
    cell = spec.load_cell("torus262k-semisup-train")
    inference = dict(cell.config["inference"], spmv_dtype=spmv_dtype, cg_tolerance=tol,
                     num_probes=num_probes, lanczos_max_iter=steps, **inference)
    config = dict(cell.config, n=n, num_test=128, inference=inference)
    cell = dataclasses.replace(cell, config=config)
    model, inputs = program.build(config, 11, CPU, {})
    loop = semisup_jobs.Loop(model, cell, 11, inputs)
    ref = check.reference_setup(inputs.train_x_raw, config["k"], CPU)
    s = semisup_jobs.setting(ref, cell, inputs, 11, CPU)
    return loop, s


@pytest.mark.parametrize("spmv_dtype,tol,loss_tol,grad_tol", [
    # f32 panels, solves (inner ones included) to 1e-4: the port reads
    # 3.3e-7 from the reference's loss, whose inner solves stop at the same
    # 1e-4 (1.6e-5 from inner solves to 1e-6), and 5e-5 of the largest
    # leaf's gradient
    ("float32", 1e-4, 1e-5, 5e-4),
    # the cell's own 1e-2: the loss follows the configured inner solves
    # (2.5e-7 from the reference's; 6.7e-3 from inner solves to 1e-4), the
    # gradient reads 1.4e-3 of the largest leaf's from tight inner solves
    ("float32", 1e-2, 1e-5, 5e-3),
    # bf16 panels and operand, the cell's stated precision, which the
    # reference rounds to as well: every apply's operand loses all but 8
    # mantissa bits, so the inner CG's true residual stays above its 1e-3
    # stop test, and the Schur complement's cancellation turns that into
    # 1.9e-2 of the loss and 2.6e-3 of the gradient at these 90 labeled
    # nodes (1e-4 of the loss at the cell's 26,010)
    ("bfloat16", 1e-3, 3e-2, 1e-2),
])
def test_port_loss_and_gradient_equal_the_reference(spmv_dtype, tol, loss_tol, grad_tol):
    loop, s = _semisup(spmv_dtype, tol)
    model = loop.model
    params = model.init_params(**loop.start)
    for v in params.values():
        v.requires_grad_(True)
    probes = loop.feed(0).probes(0)
    loss = model.mll_loss(params, probes=probes)
    loss.backward()
    raw = {k: v.detach().double() for k, v in params.items()}
    ref_loss, ref_grads = s.problem.loss_and_grad(raw, probes.double())
    assert abs(float(loss) - ref_loss) < loss_tol
    scale = max(abs(float(ref_grads[k])) for k in RAW)
    for k in RAW:
        assert abs(float(params[k].grad) - float(ref_grads[k])) < grad_tol * scale, k


def test_schur_counters_agree_with_the_iteration_log():
    """One loss and backward under tracing: ``cg.solves.schur_inner`` and
    ``cg.iterations.schur_inner`` are the log's inner entries; every
    forward apply of S counts ``schur.applies.<columns>`` and runs one
    inner solve; the applies made under autograd (3 for the quadratic
    term, 3 for the log-det's cotangents) add one adjoint solve each."""
    loop, _ = _semisup("float32", 1e-1, num_probes=4, steps=4, n=400, precond_rank=3)
    model = loop.model
    params = model.init_params(**loop.start)
    for v in params.values():
        v.requires_grad_(True)
    probes = loop.feed(0).probes(0)
    metrics.reset()
    cg.iteration_log = []
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            model.mll_loss(params, probes=probes).backward()
        log = [e for e in cg.iteration_log if e[0] == "schur_inner"]
    finally:
        cg.iteration_log = None
    counters = metrics.traced()["counters"]
    metrics.reset()
    applies = {int(k.rsplit(".", 1)[1]): v for k, v in counters.items()
               if k.startswith("schur.applies.")}
    assert counters["cg.solves.schur_inner"] == len(log)
    assert counters["cg.iterations.schur_inner"] == sum(e[3] for e in log)
    assert sum(applies.values()) == len(log) - 6
    widths = {w: sum(1 for e in log if e[2] == w) for w in applies}
    assert widths == {1: applies[1] + 3, 4: applies[4] + 3}


def test_labeled_mask_is_fixed_and_a_tenth():
    config = json.loads((CONFIGS / "torus262k-semisup.json").read_text())
    n = config["n"] - config["num_test"]
    a = semisup_jobs.labeled_mask(config, n)
    b = semisup_jobs.labeled_mask(dict(config), n)
    assert n == 260_096 and np.array_equal(a, b)
    assert int(a.sum()) == round(0.1 * 260_096) == 26_010


def test_semisup_configuration_is_the_torus_plus_its_mask():
    """torus262k-semisup differs from torus262k only in ``labeled_fraction``
    and in its notes: its name, its source and the sizes it assumed."""
    base = json.loads((CONFIGS / "torus262k.json").read_text())
    semi = json.loads((CONFIGS / "torus262k-semisup.json").read_text())
    differ = {k for k in base.keys() | semi.keys() if base.get(k) != semi.get(k)}
    assert differ == {"labeled_fraction", "name", "source", "assumed"}
    assert semi["assumed"][:len(base["assumed"])] == base["assumed"]
