"""Traffic ``"loop": "semisup_jobs"``: ``train_jobs``' closed loop of
training jobs on the semi-supervised model. The graph covers every training
node; the labels are kept on a fixed ``labeled_fraction`` of them
(``labeled_mask``, drawn from the configuration's ``data_seed``), and
``RiemannGP(train_x[mask], train_y[mask], kernel, labeled=mask)``
marginalizes the rest through the Schur complement, an inner CG on the
unlabeled block at every apply. Each job is ``manifold_informed_train``,
as in ``train_jobs``; an epoch's probes cover the labeled rows, the
normalization's one-hot indices every node. End-to-end: ``epoch_ms``.

The check is ``train_jobs``' (``graph_edges_off``, ``norm_gap``,
``loss_gap``, ``grad_gap``, ``step_gap``) against the float64 Schur
reference (``reference/semisup.py``): its loss with inner solves to the
configuration's tolerance, its gradient with tighter ones. The control and
the planted faults are ``train_jobs``' (half of the labeled nodes keep
their labels on the same graph, half of the probes, altered losses, a
flipped gradient), and the Schur correction dropped ("no_schur": Q_ll in
S's place).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..harness import check
from ..harness.program import seed_int
from ..reference import semisup as ref_semisup
from ..reference import train as ref_train
from . import train_jobs
from .train_jobs import INDICES, HalfFeed, Setting, TrainFeed, in_place, indices, numbers

LABELS = 4  # seed tag of the labeled mask, apart from the sample's own draws


def labeled_mask(config: dict, n: int) -> np.ndarray:
    """[n] bool: ``round(labeled_fraction * n)`` nodes, the same in every
    run (from the configuration's ``data_seed``)."""
    rng = np.random.default_rng([int(config["data_seed"]), LABELS])
    mask = np.zeros(n, bool)
    mask[rng.choice(n, round(float(config["labeled_fraction"]) * n), replace=False)] = True
    return mask


class SemisupFeed(TrainFeed):
    """``TrainFeed`` with probes over the ``n`` labeled rows and one-hot
    indices over all ``nodes``."""

    def __init__(self, seed: int, job: int, n: int, nodes: int, num_probes: int,
                 num_rand_vec: int, device):
        super().__init__(seed, job, n, num_probes, num_rand_vec, device)
        self.nodes = nodes

    def indices(self, epoch: int) -> torch.Tensor:
        return indices(self.nodes, self.num_rand_vec,
                       seed_int(self.seed, self.job, epoch, INDICES), self.device)


class Loop(train_jobs.Loop):
    """Closed loop of training jobs on the semi-supervised model built over
    ``model``'s kernel."""

    def __init__(self, model, cell, seed: int, inputs):
        from manifold_gp_torch import RiemannGP

        mask = labeled_mask(cell.config, model.kernel.graph.num_nodes)
        rows = torch.as_tensor(mask, device=model.device)
        semi = RiemannGP(model.train_x[rows], model.train_y[rows], model.kernel, labeled=mask,
                         cfg=model.cfg)
        super().__init__(semi, cell, seed, inputs)

    def feed(self, job: int) -> SemisupFeed:
        return SemisupFeed(self.seed, job, self.model.num_data,
                           self.model.kernel.graph.num_nodes, self.model.cfg.num_probes,
                           int(self.traffic["num_rand_vec"]), self.model.device)


def setting(ref: check.Reference, cell, inputs, seed: int, device, precision: str = None,
            problem_type=ref_semisup.SemisupProblem) -> Setting:
    config, traffic = cell.config, cell.traffic
    mask = labeled_mask(config, ref.graph.n)
    feed = SemisupFeed(seed, 0, int(mask.sum()), ref.graph.n,
                       int(config["inference"]["num_probes"]), int(traffic["num_rand_vec"]),
                       device)
    y = torch.as_tensor(inputs.train_y[mask], dtype=torch.float64, device=device)
    problem = problem_type(
        ref.graph, y, torch.as_tensor(mask, device=device), ref.gb_floor, config["nu"],
        config["inference"],
        precision=precision or check.STATED[config["inference"]["spmv_dtype"]])
    return Setting(problem, config[traffic["start"]], feed, float(traffic["lr"]))


def judge(ref, record, cell, inputs, seed: int, device) -> dict:
    return numbers(ref, setting(ref, cell, inputs, seed, device), record)


class HalfLabeledFeed(HalfFeed):
    """The probe rows of the first ``rows`` labeled nodes; the
    normalization's indices as they were, over every node of the graph."""

    def indices(self, epoch):
        return self.feed.indices(epoch)


class _LabeledBlock(ref_semisup.Schur):
    """Q_ll in S's place: the labeled rows of Q with no correction."""

    def hat(self, v):
        return self.embed(self.li, v)


class _NoSchurProblem(ref_semisup.SemisupProblem):
    """The reference with the Schur correction dropped (S -> Q_ll)."""

    def schur(self, prec, tol=None):
        return _LabeledBlock(prec, self.li, self.ui, self.tol if tol is None else tol,
                             self.max_iter)

    @torch.no_grad()
    def solve(self, sch, z):
        ones = torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
        return ref_train.cg(self.noisy(sch), z, ones, self.tol, self.max_iter)[0]


def control(ref, record, cell, inputs, seed: int, device) -> dict:
    """The numbers of the control and of the planted faults (as
    ``train_jobs.control``), each the reference in the program's place:
    half of the batch left out, as the first half of the labeled nodes
    keeping their labels on the same graph ("half_rows") and as the first
    half of the probe columns ("half_probes"); the losses altered by 1 %
    ("altered"); the gradient of the leaf with the smallest counted
    reference gradient flipped ("flipped"); and the Schur correction
    dropped ("no_schur")."""
    steps = len(record.losses)
    s = setting(ref, cell, inputs, seed, device)
    low = setting(ref, cell, inputs, seed, device, precision=cell.limits["control"])
    no_schur = setting(ref, cell, inputs, seed, device, problem_type=_NoSchurProblem)
    p = s.problem
    rows = p.li.shape[0] // 2
    half_mask = torch.zeros(ref.graph.n, dtype=torch.bool, device=device)
    half_mask[p.li[:rows]] = True
    half = ref_semisup.SemisupProblem(ref.graph, p.y[:rows], half_mask, ref.gb_floor, p.nu,
                                      p.inference, precision=p.precision)
    g0 = {key: abs(float(v)) for key, v in record.grad0.items()}
    median = float(np.median(list(g0.values())))
    leaf = min((key for key, v in g0.items() if v >= 1e-3 * median), key=g0.get)
    altered = dataclasses.replace(record, losses=[v * 1.01 for v in record.losses])
    runs = (("control", lambda: in_place(low, ref, steps, neighbors=cell.config["k"])),
            ("half_rows", lambda: in_place(dataclasses.replace(
                s, problem=half, feed=HalfLabeledFeed(s.feed, rows)), ref, steps)),
            ("half_probes", lambda: in_place(dataclasses.replace(s, feed=HalfFeed(s.feed)),
                                             ref, steps)),
            ("altered", lambda: altered),
            ("flipped", lambda: in_place(s, ref, steps, flip=leaf)),
            ("no_schur", lambda: in_place(no_schur, ref, steps)))
    return {name: numbers(ref, s, run()) for name, run in runs}
