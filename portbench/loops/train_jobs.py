"""Traffic ``"loop": "train_jobs"``: a closed loop of training jobs, each
``manifold_informed_train`` for ``epochs_per_job`` epochs from the
configuration's ``start`` values ("hypers": the trained ones, or
"initial_hypers"), with ``lr``, ``tolerance``, ``num_rand_vec`` and the
configuration's ``precond_refresh``; the probes of every epoch and the
one-hot indices of every normalization are drawn from the seed and handed
in. End-to-end: ``epoch_ms``, the window over the epochs of its whole jobs.

The check reads the window's first job, its first ``checked_steps`` epochs:
  graph_edges_off  (``harness/check``);
  norm_gap         |s / s_ref - 1| of the outputscale the job's
                   normalization set (the reference's one-hot solve on the
                   same indices);
  loss_gap         the largest |loss - loss_ref| over the steps, the
                   reference's loss at the program's parameters and probes;
  grad_gap         the first gradient as the optimizer got it, by the worst
                   leaf: |g - g_ref| / max(|g_ref|, the median leaf's |g_ref|);
  step_gap         the parameters' change over the steps, by the worst
                   leaf, the same signed measure against the reference's own
                   Adam steps from the program's first parameters.
  Leaves whose reference gradient is below a thousandth of the median
  leaf's (the mean, which the loss does not reach) are left out of both.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..harness import check
from ..harness.program import counters, counters_since, seed_int, sync
from ..reference import operator as ref_op
from ..reference import train as ref_train

PROBES, INDICES = 0, 1
WARM_UP_JOB = 1 << 30  # the warm-up job's draws, apart from every window job's


def rademacher(n: int, columns: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (n, columns), generator=gen, device=device)
    return (2 * bits - 1).to(torch.float32)


def indices(n: int, count: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n, (count,), generator=gen, device=device)


class TrainFeed:
    """The probes and indices of one job, a function of (seed, job, epoch)."""

    def __init__(self, seed: int, job: int, n: int, num_probes: int, num_rand_vec: int,
                 device):
        self.seed, self.job, self.n = seed, job, n
        self.num_probes, self.num_rand_vec, self.device = num_probes, num_rand_vec, device

    def probes(self, epoch: int) -> torch.Tensor:
        return rademacher(self.n, self.num_probes,
                          seed_int(self.seed, self.job, epoch, PROBES), self.device)

    def indices(self, epoch: int) -> torch.Tensor:
        return indices(self.n, self.num_rand_vec,
                       seed_int(self.seed, self.job, epoch, INDICES), self.device)


class JobRecord:
    """What the check reads of a job's first ``steps`` epochs: the raw
    parameters before each of them and after the last, each epoch's loss,
    and the first gradient as the optimizer got it."""

    def __init__(self, params: dict, steps: int):
        self.params, self.steps = params, steps
        self.raw, self.losses, self.grad0 = [], [], None

    def _snapshot(self):
        return {k: v.detach().clone() for k, v in self.params.items()}

    def before(self, epoch: int):
        if epoch < self.steps and len(self.raw) == epoch:
            self.raw.append(self._snapshot())

    def record(self, epoch: int, **values):
        if epoch < self.steps:
            self.losses.append(values["loss"])
            if epoch == 0:
                self.grad0 = {k: (torch.zeros_like(v) if v.grad is None
                                  else v.grad.detach().clone())
                              for k, v in self.params.items()}
            if epoch == self.steps - 1:
                self.raw.append(self._snapshot())


@dataclasses.dataclass
class TrainRecord:
    raw: list  # raw parameters before each checked step and after the last
    losses: list
    grad0: dict
    graph_rows: np.ndarray = None
    graph_cols: np.ndarray = None


class Loop:
    """Closed loop of training jobs."""

    def __init__(self, model, cell, seed: int, inputs):
        self.model, self.config, self.traffic, self.seed = model, cell.config, cell.traffic, seed
        self.start = self.config[self.traffic["start"]]
        self.epochs = int(self.traffic["epochs_per_job"])
        self.steps = int(self.traffic["checked_steps"])
        self.first = None  # the window's first job's JobRecord

    def feed(self, job: int) -> TrainFeed:
        return TrainFeed(self.seed, job, self.model.num_data, self.model.cfg.num_probes,
                         int(self.traffic["num_rand_vec"]), self.model.device)

    def job(self, job: int, epochs: int) -> JobRecord:
        from manifold_gp_torch.utils import manifold_informed_train

        params = self.model.init_params(**self.start)
        feed = self.feed(job)
        rec = JobRecord(params, self.steps)

        def probes_fn(epoch):
            rec.before(epoch)
            return feed.probes(epoch)

        manifold_informed_train(
            self.model, params, lr=float(self.traffic["lr"]), weight_decay=0.0,
            max_iter=epochs - 1, tolerance=float(self.traffic["tolerance"]),
            num_rand_vec=int(self.traffic["num_rand_vec"]), metrics=rec,
            precond_refresh=int(self.config["precond_refresh"]), probes_fn=probes_fn,
            idx_fn=feed.indices)
        return rec

    def warm_up(self):
        """One job of one epoch: every width a job launches (the
        normalization's one-hot solve, the preconditioner build, the
        epoch's probes and labels)."""
        self.job(WARM_UP_JOB, 1)
        sync(self.model.device)

    def window(self, seconds: float) -> dict:
        """Whole jobs until ``seconds`` have passed: the work done."""
        device = self.model.device
        jobs = epochs = failed = 0
        before = counters()
        sync(device)
        t0 = time.perf_counter()
        while True:
            rec = self.job(jobs, self.epochs)
            if self.first is None:
                self.first = rec
            jobs += 1
            epochs += self.epochs
            if not all(math.isfinite(v) for v in rec.losses):
                failed += self.epochs
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        elapsed = time.perf_counter() - t0
        return {"window_s": elapsed, "units": epochs, "failed": failed,
                "counters": counters_since(before),
                "end_to_end": {"epoch_ms": elapsed * 1e3 / epochs}}

    def record(self) -> TrainRecord:
        graph = self.model.kernel.graph
        first = self.first
        return TrainRecord(
            raw=[{k: v.cpu() for k, v in r.items()} for r in first.raw],
            losses=list(first.losses), grad0={k: v.cpu() for k, v in first.grad0.items()},
            graph_rows=graph.rows.cpu().numpy(), graph_cols=graph.cols.cpu().numpy())


@dataclasses.dataclass
class Setting:
    """What the reference needs besides the record: the problem in the
    configuration's stated precision, the start values, the job's feed
    and learning rate."""

    problem: ref_train.Problem
    start: dict
    feed: TrainFeed
    lr: float


def setting(ref: check.Reference, cell, inputs, seed: int, device,
            precision: str = None) -> Setting:
    config, traffic = cell.config, cell.traffic
    feed = TrainFeed(seed, 0, ref.graph.n, int(config["inference"]["num_probes"]),
                     int(traffic["num_rand_vec"]), device)
    y = torch.as_tensor(inputs.train_y, dtype=torch.float64, device=device)
    problem = ref_train.Problem(
        ref.graph, y, ref.gb_floor, config["nu"], config["inference"],
        precision=precision or check.STATED[config["inference"]["spmv_dtype"]])
    return Setting(problem, config[traffic["start"]], feed, float(traffic["lr"]))


def numbers(ref: check.Reference, s: Setting, rec: TrainRecord) -> dict:
    """The training numbers of ``rec`` (see the module's docstring)."""
    problem, feed = s.problem, s.feed
    device = problem.y.device
    steps = len(rec.losses)
    out = {}
    if rec.graph_rows is not None:
        out["graph_edges_off"] = check.edges_off(ref, rec.graph_rows, rec.graph_cols)
    raw_start = ref_op.raw_from_values(s.start, ref.gb_floor, device=device)
    s_ref = problem.normalized_outputscale(raw_start, feed.indices(0))
    s_rec = float(ref_op.softplus(check.f64(rec.raw[0], device)["raw_outputscale"]))
    out["norm_gap"] = abs(s_rec / s_ref - 1.0)
    out["loss_gap"] = max(
        abs(rec.losses[i] - problem.loss(check.f64(rec.raw[i], device), feed.probes(i).double()))
        for i in range(steps))
    raw0 = check.f64(rec.raw[0], device)
    (_, g_ref), raw_after = ref_train.follow(problem, raw0, lambda i: feed.probes(i).double(),
                                             steps, s.lr)
    median = float(np.median([abs(float(g)) for g in g_ref.values()]))
    counted = [k for k, g in g_ref.items() if abs(float(g)) >= 1e-3 * median]
    out["grad_gap"] = check.leaf_gap(rec.grad0, g_ref, counted)
    moved_rec = {k: float(rec.raw[steps][k]) - float(rec.raw[0][k]) for k in counted}
    moved_ref = {k: float(raw_after[k] - raw0[k]) for k in counted}
    out["step_gap"] = check.leaf_gap(moved_rec, moved_ref, counted)
    return out


def judge(ref, record, cell, inputs, seed: int, device) -> dict:
    return numbers(ref, setting(ref, cell, inputs, seed, device), record)


def in_place(s: Setting, ref: check.Reference, steps: int, neighbors: int = None,
             flip: str = None) -> TrainRecord:
    """What the reference in ``s.problem``'s precision produces in the
    program's place: the graph (with ``neighbors``: the control's kNN
    search), the normalization, then ``steps`` Adam steps; ``flip``: the
    leaf whose gradient the optimizer gets with its sign flipped."""
    problem, feed = s.problem, s.feed
    device = problem.y.device
    raw = ref_op.raw_from_values(s.start, ref.gb_floor, device=device)
    scale = problem.normalized_outputscale(raw, feed.indices(0))
    raw["raw_outputscale"] = ref_op.raw_from_values(
        {**s.start, "outputscale": scale}, ref.gb_floor, device=device)["raw_outputscale"]
    leaves = {k: v.detach().clone() for k, v in raw.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=s.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0)
    rec = TrainRecord(raw=[], losses=[], grad0=None)
    if neighbors is not None:
        rec.graph_rows, rec.graph_cols = check.control_graph(ref, neighbors)
    for step in range(steps):
        rec.raw.append({k: v.detach().clone() for k, v in leaves.items()})
        loss, grads = problem.loss_and_grad(leaves, feed.probes(step).double())
        if flip is not None:
            grads[flip] = -grads[flip]
        rec.losses.append(loss)
        if step == 0:
            rec.grad0 = {k: g.clone() for k, g in grads.items()}
        for k, v in leaves.items():
            v.grad = grads[k]
        opt.step()
    rec.raw.append({k: v.detach().clone() for k, v in leaves.items()})
    return rec


class HalfFeed:
    """A feed for the first ``rows`` training rows, or with the first half of
    every epoch's probe columns (``rows=None``)."""

    def __init__(self, feed, rows: int = None):
        self.feed, self.rows = feed, rows

    def probes(self, epoch):
        full = self.feed.probes(epoch)
        return full[:, : full.shape[1] // 2] if self.rows is None else full[: self.rows]

    def indices(self, epoch):
        idx = self.feed.indices(epoch)
        return idx if self.rows is None else idx % self.rows


def control(ref, record, cell, inputs, seed: int, device) -> dict:
    """The numbers of the control (the reference in the cell's lower
    precision, ``limits/<cell>.json``'s "control", in the program's place)
    and of planted faults, each the reference in the program's place: half
    of the batch left out, the mean taken over the rest, as the first half
    of the training rows ("half_rows") and as the first half of the probe
    columns ("half_probes"); the record's losses altered by 1 % where they
    are produced ("altered"); the gradient of the leaf with the smallest
    counted reference gradient given to the optimizer with its sign flipped
    ("flipped"). A state left unchanged reads 1 on step_gap by definition."""
    k = cell.config["k"]
    steps = len(record.losses)
    s = setting(ref, cell, inputs, seed, device)
    low = setting(ref, cell, inputs, seed, device, precision=cell.limits["control"])
    rows = ref.graph.n // 2
    half_ref = check.reference_setup(ref.raw_x[:rows], k, device)
    half_problem = ref_train.Problem(half_ref.graph, s.problem.y[:rows], half_ref.gb_floor,
                                     s.problem.nu, s.problem.inference, s.problem.precision)
    half_rows = in_place(dataclasses.replace(s, problem=half_problem,
                                             feed=HalfFeed(s.feed, rows)), half_ref, steps)
    half_probes = in_place(dataclasses.replace(s, feed=HalfFeed(s.feed)), ref, steps)
    g0 = {key: abs(float(v)) for key, v in record.grad0.items()}
    median = float(np.median(list(g0.values())))
    leaf = min((key for key, v in g0.items() if v >= 1e-3 * median), key=g0.get)
    flipped = in_place(s, ref, steps, flip=leaf)
    altered = dataclasses.replace(record, losses=[v * 1.01 for v in record.losses])
    return {name: numbers(ref, s, r)
            for name, r in (("control", in_place(low, ref, steps, neighbors=k)),
                            ("half_rows", half_rows), ("half_probes", half_probes),
                            ("altered", altered), ("flipped", flipped))}
