"""The port's spans and counters (``utils.metrics``) on the CPU: tracing is
on exactly while a ``torch.profiler`` records; spans then show among the
profiler's events, nested as the calls are; the CG counters agree with
``ops.cg.iteration_log``; the host reads of a training epoch are counted
site by site; and the set-up spans are timed with no profiler running."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import manifold_gp_torch as T
from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from examples_torch.run_large import torus_points
from manifold_gp_torch.ops import cg
from manifold_gp_torch.ops.eigen import lobpcg_smallest
from manifold_gp_torch.ops.graph import build_graph
from manifold_gp_torch.ops.sparse_formats import build_layout
from manifold_gp_torch.utils import manifold_informed_train, metrics
from manifold_gp_torch.utils.metrics import count, counter_sum, span

INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.15, lengthscale=1.0)


@pytest.fixture(autouse=True)
def empty_registries():
    metrics.reset(include_totals=True)
    yield
    metrics.reset(include_totals=True)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spd(n=60, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return torch.from_numpy(a @ a.T / n + np.eye(n, dtype=np.float32))


def _model(n=300, precond_type="pivchol"):
    x, u, _ = torus_points(n, seed=3)
    y = (np.sin(2 * u) + 0.1 * np.random.default_rng(3).standard_normal(n)).astype(np.float32)
    cfg = T.InferenceConfig(dense_operator_max_size=0, use_dia=False, max_cholesky=0,
                            num_probes=8, lanczos_max_iter=12, cg_tolerance=1e-4,
                            cg_max_iter=400, precond_type=precond_type, precond_rank=5,
                            solve_cotangent="edge")
    kernel = T.RiemannMaternKernel(nu=2, x=x, nearest_neighbors=10,
                                   laplacian_normalization="randomwalk", cfg=cfg,
                                   graphbandwidth_constraint=T.GreaterThan(0.02), device="cpu")
    return T.RiemannGP(x, y, kernel, cfg=cfg)


def test_tracing_is_the_profilers_private_flag():
    """``tracing()`` reads ``torch.autograd.profiler._is_profiler_enabled``,
    which ``torch.profiler.profile`` sets while it records."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False and not metrics.tracing()
    with _cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True and metrics.tracing()
    assert not metrics.tracing()


def test_span_is_a_cpu_range_not_a_user_annotation():
    """A span records through ``torch._C._profiler._RecordFunctionFast``: a
    CPU range of the span's name that is not a user annotation (which the
    profiler would mirror on the device's timeline as device work)."""
    with _cpu_profile() as prof:
        with span("imgp.test.range"):
            torch.ones(4) + 1
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "imgp.test.range"]
    assert event.device_type() == torch.autograd.DeviceType.CPU
    assert not event.is_user_annotation() and event.duration_ns() > 0


def test_span_without_a_profiler_records_nothing(monkeypatch):
    def no_record(name):
        raise AssertionError(f"a range {name!r} recorded with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_record)
    with span("imgp.test.off"):
        count("test.off", 5)
    x = cg.cg_raw(lambda v: _spd() @ v, torch.ones(60), 1e-4, 100, log_label="off")
    assert torch.isfinite(x).all()
    assert metrics.traced() == {"counters": {}, "spans": {}}
    assert metrics.totals() == {}


def test_spans_nest_in_the_profilers_events():
    """One training epoch under the CPU profiler: the CG solve of the SLQ
    gradient lies inside the epoch, and its iterations inside the solve."""
    model = _model(precond_type="jacobi")
    params = model.init_params(**INIT)
    with _cpu_profile() as prof:
        manifold_informed_train(model, params, max_iter=0, num_rand_vec=10, seed=3)
    events = [e for e in prof.events() if e.name.startswith("imgp.")]
    names = {e.name for e in events}
    assert {"imgp.train.run", "imgp.train.epoch", "imgp.train.normalize", "imgp.train.step",
            "imgp.train.backward", "imgp.operator.apply", "imgp.operator.vjp",
            "imgp.model.mll_loss", "imgp.solver.cg", "imgp.cg.step",
            "imgp.lanczos.step", "imgp.operator.assemble"} <= names

    def inside(inner, outer):
        return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    epoch = next(e for e in events if e.name == "imgp.train.epoch")
    solves = [e for e in events if e.name == "imgp.solver.cg" and inside(e, epoch)]
    steps = [e for e in events if e.name == "imgp.cg.step"]
    assert solves and any(inside(s, c) for s in steps for c in solves)
    assert all(any(inside(s, c) for c in events if c.name == "imgp.solver.cg") for s in steps)
    spans = metrics.traced()["spans"]
    assert spans["imgp.train.epoch"]["count"] == 1
    assert spans["imgp.cg.step"]["count"] == len(steps)


def test_cg_counters_equal_the_iteration_log():
    """``cg.iterations.<label>`` sums ``iteration_log``'s iterations over the
    same calls; ``cg.capped`` counts a solve cut at a ``max_iter`` too small
    to converge, and not one that converges at its last iteration."""
    a = _spd()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((60, 3)).astype(np.float32))
    cg.iteration_log = []
    try:
        with _cpu_profile():
            _, needed = cg.cg_raw(lambda v: a @ v, b, 1e-5, 500, with_info=True, log_label="a")
            cg.cg_raw(lambda v: a @ v, b, 1e-5, needed, log_label="a")
            cg.cg_raw(lambda v: a @ v, b, 1e-5, 2, log_label="b")
            cg.cg_raw(lambda v: a @ v, b[:, 0], 1e-3, 500)
        log = cg.iteration_log
    finally:
        cg.iteration_log = None
    counters = metrics.traced()["counters"]
    for label, key in (("a", "a"), ("b", "b"), (None, "unlabeled")):
        assert counters[f"cg.iterations.{key}"] == sum(e[3] for e in log if e[0] == label)
        assert counters[f"cg.solves.{key}"] == sum(1 for e in log if e[0] == label)
    assert counter_sum(counters, "cg.iterations") == sum(e[3] for e in log)
    assert 2 < needed < 500
    assert counters["cg.capped.b"] == 1 and counters.get("cg.capped.a", 0) == 0
    assert counter_sum(counters, "cg.capped") == 1
    # one stop-test read per iteration, one more where the test ended the loop
    stops = sum(it + (it < cap) for (_, _, _, it), cap in zip(log, (500, needed, 2, 500)))
    assert counters["host_sync.cg.stop"] == stops


def test_host_syncs_of_a_training_epoch_are_counted_by_site():
    """One epoch with a pivoted-Cholesky preconditioner built for it: the
    host synchronizations are the CG stop tests of its solves, the one-hot
    columns' scalar written from the host (once a normalization), the SLQ
    quadrature's ``eigh``, the preconditioner's ``cholesky`` and the
    trainer's reads of the loss and the four parameters."""
    model = _model()
    params = model.init_params(**INIT)
    cg.iteration_log = []
    try:
        with _cpu_profile():
            manifold_informed_train(model, params, max_iter=0, num_rand_vec=10, seed=3,
                                    precond_refresh=1)
        log = cg.iteration_log
    finally:
        cg.iteration_log = None
    counters = metrics.traced()["counters"]
    max_iter = model.cfg.cg_max_iter
    assert {e[0] for e in log} == {"avg_var", "slq_grad"}
    assert sum(1 for e in log if e[0] == "avg_var") == 2  # before and after the loop
    expected = {
        "host_sync.cg.stop": sum(it + (it < max_iter) for *_, it in log),
        "host_sync.avg_var.onehot": 2,
        "host_sync.eigh.slq": 1,
        "host_sync.cholesky.precond": 1,
        "host_sync.train.loss": 1,
        "host_sync.train.params": 4,
    }
    assert {k: v for k, v in counters.items() if k.startswith("host_sync.")} == expected
    assert counter_sum(counters, "cg.iterations") == sum(e[3] for e in log)
    spans = metrics.traced()["spans"]
    assert spans["imgp.train.normalize"]["count"] == 2
    assert spans["imgp.train.precond_build"]["count"] == 1
    assert spans["imgp.pivchol.step"]["count"] == 5


def test_lobpcg_counts_its_iterations_and_eighs():
    a = _spd(n=200, seed=2)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((200, 4)).astype(np.float32))
    with _cpu_profile():
        vals, _ = lobpcg_smallest(lambda v: a @ v, x0, float(torch.linalg.norm(a)), max_iter=7)
    counters = metrics.traced()["counters"]
    assert torch.isfinite(vals).all()
    assert counters["lobpcg.iterations"] == 7
    # the start block's two SVQB passes, then four in _project_out and the
    # Rayleigh-Ritz step each iteration; one SVD (two reads of its status)
    # extends the start block
    assert counters["host_sync.eigh.lobpcg"] == 2 + 5 * 7
    assert counters["host_sync.svd.lobpcg"] == 2
    spans = metrics.traced()["spans"]
    assert spans["imgp.solver.lobpcg"]["count"] == 1 and spans["imgp.lobpcg.step"]["count"] == 7
    assert spans["imgp.lobpcg.svqb"]["count"] == 2 + 4 * 7
    assert spans["imgp.operator.apply"]["count"] == 1 + 2 * 7


def test_setup_spans_are_timed_without_a_profiler():
    x, _, _ = torus_points(400, seed=1)
    graph = build_graph(x, 10, device=torch.device("cpu"))
    assert build_layout(graph, use_dia=False) is not None
    totals = metrics.totals()
    for name in ("imgp.graph.search", "imgp.graph.host_tail", "imgp.layout.build"):
        assert totals[name]["count"] == 1 and totals[name]["seconds"] > 0
    assert metrics.traced() == {"counters": {}, "spans": {}}
