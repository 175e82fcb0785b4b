"""Traffic ``"loop": "standup"``: a closed loop of predictor stand-ups at
the configuration's trained values, each ``RiemannGP.eval`` (a full basis
solve: no stand-up reuses another's basis) and ``RiemannGP.posterior`` at
the held-out points. End-to-end: ``predictor_s``, the window over its whole
stand-ups.

The check reads a stand-up drawn from the seed, and the reference solves
its own basis (``reference/eigen``: the lowest modes of its float64
Laplacian from a start drawn from the seed):
  graph_edges_off  (``harness/check``);
  launches_min     the fewest forward launches of any stand-up (a full basis
                   solve in each: none served from another's);
  query_nbrs_off   the share of query points whose k nearest training points,
                   as the program found them, are not the reference's;
  eig_gap          the worst mode's |l - l_ref| / max(l_ref, the median
                   mode's l_ref) against the reference's own eigenvalues;
  resid_max        the worst mode's ||L u - l u|| / bound under the
                   reference's Laplacian (``eig_resid``: the median mode's);
  ortho_off        max |U'U - I| of the returned basis (u = D^1/2 v, each
                   column normalized);
  mean_gap         max |mean - mean_ref| / max |mean_ref| over the query
                   points, the reference's posterior from the program's
                   basis (the Woodbury algebra alone);
  var_gap          max |var - var_ref| / max var_ref, the same;
  mean_gap_own     the posterior's mean from the program's basis against the
                   reference's from its own, both by the reference's algebra
                   on the lowest ``modes_own`` modes (``eigen.cluster_cut``:
                   the most that end at a gap in the reference's spectrum);
  var_gap_own      the same for the variance.
  The posterior numbers leave out the query points whose neighbour sets
  differ (``query_nbrs_off``) or include an endpoint of an edge that is in
  one graph and not the other (its degree differs): ``left_out``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..harness import check
from ..harness.program import counters, counters_since, seed_int, sync
from ..reference import eigen as ref_eigen
from ..reference import operator as ref_op
from ..reference import serve as ref_serve

PICK, EIGEN_START = 7, 8  # seed tags: the stand-up checked, the reference's start block


@dataclasses.dataclass
class ServeRecord:
    eigval: torch.Tensor
    eigvec: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    query_idx: torch.Tensor = None  # [nt, k]: the program's neighbours of each query
    launches_min: int = None
    graph_rows: np.ndarray = None
    graph_cols: np.ndarray = None


class Loop:
    """Closed loop of predictor stand-ups."""

    def __init__(self, model, cell, seed: int, inputs):
        self.model, self.traffic, self.seed = model, cell.traffic, seed
        self.k = int(cell.config["k"])
        self.params = model.init_params(**cell.config["hypers"])
        self.test_x = torch.as_tensor(inputs.test_x, dtype=torch.float32).to(model.device)
        self.outputs = []  # per stand-up: (eigval, eigvec, mean, var, forward launches)
        kernel = model.kernel
        solve, search = kernel.eval_basis, kernel.knn.search
        self._basis = self._query_idx = None

        def recorded(params):
            self._basis = solve(params)
            return self._basis

        def searched(queries, k, self_query=None):
            sqd, idx = search(queries, k, self_query=self_query)
            if k == self.k and queries is self.test_x:
                self._query_idx = idx
            return sqd, idx

        kernel.eval_basis, kernel.knn.search = recorded, searched

    def one(self):
        self.model.eval(self.params)
        post = self.model.posterior(self.params, self.test_x,
                                    noisy_posterior=bool(self.traffic["noisy_posterior"]))
        return self._basis, post.mean, torch.diagonal(post.covar)

    def warm_up(self):
        """A stand-up with a two-iteration basis solve: every width and
        dense factorization of the stand-up, once."""
        kernel = self.model.kernel
        cfg = kernel.cfg
        kernel.cfg = cfg.replace(eigensolver_max_iter=2)
        try:
            self.one()
        finally:
            kernel.cfg = cfg
        sync(self.model.device)

    def window(self, seconds: float) -> dict:
        device = self.model.device
        failed = 0
        before_all = counters()
        sync(device)
        t0 = time.perf_counter()
        while True:
            before = counters()
            (eigval, eigvec), mean, var = self.one()
            launches = sum(counters_since(before)["fwd"].values())
            self.outputs.append((eigval, eigvec, mean, var, launches))
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        elapsed = time.perf_counter() - t0
        for _, _, mean, var, _ in self.outputs:
            if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())):
                failed += 1
        units = len(self.outputs)
        return {"window_s": elapsed, "units": units, "failed": failed,
                "counters": counters_since(before_all),
                "end_to_end": {"predictor_s": elapsed / units}}

    def record(self) -> ServeRecord:
        graph = self.model.kernel.graph
        pick = seed_int(self.seed, PICK) % len(self.outputs)
        eigval, eigvec, mean, var, _ = self.outputs[pick]
        return ServeRecord(eigval=eigval, eigvec=eigvec, mean=mean, var=var,
                           query_idx=self._query_idx,
                           launches_min=min(o[4] for o in self.outputs),
                           graph_rows=graph.rows.cpu().numpy(),
                           graph_cols=graph.cols.cpu().numpy())


@dataclasses.dataclass
class Setting:
    """The reference's side of a stand-up: its Laplacian at the trained
    values, the values, the query points' neighbours, the labels, and its
    own basis."""

    coeffs: ref_op.Coeffs
    vals: dict
    nbrs: tuple
    y: torch.Tensor
    own: dict


def setting(ref: check.Reference, cell, inputs, seed: int, device,
            precision: str = "f64", max_passes: int = 60) -> Setting:
    config = cell.config
    raw = ref_op.raw_from_values(config["hypers"], ref.gb_floor, device=device)
    vals = ref_op.values(raw, ref.gb_floor)
    coeffs = ref_op.Coeffs(ref.graph, vals["graphbandwidth"])
    xs = torch.as_tensor(ref.raw_x, dtype=torch.float64, device=device) / ref.eps
    ts = torch.as_tensor(inputs.test_x_raw, dtype=torch.float64, device=device) / ref.eps
    own = ref_eigen.lowest(coeffs, xs, int(config["num_modes"]), seed_int(seed, EIGEN_START),
                           precision=precision, max_passes=max_passes)
    return Setting(coeffs, vals, ref_serve.neighbours(xs, ts, config["k"]),
                   torch.as_tensor(inputs.train_y, dtype=torch.float64, device=device), own)


def numbers(ref: check.Reference, s: Setting, cell, rec: ServeRecord) -> dict:
    config = cell.config
    out = {}
    clear = torch.ones(s.nbrs[1].shape[0], dtype=torch.bool, device=s.y.device)
    if rec.graph_rows is not None:
        out["graph_edges_off"] = check.edges_off(ref, rec.graph_rows, rec.graph_cols)
        clear &= ~check.differing_nodes(ref, rec.graph_rows, rec.graph_cols)[s.nbrs[1]].any(dim=1)
    if rec.query_idx is not None:
        mine = torch.sort(rec.query_idx.to(s.y.device).long(), dim=1).values
        same = (mine == torch.sort(s.nbrs[1], dim=1).values).all(dim=1)
        out["query_nbrs_off"] = float((~same).double().mean())
        clear &= same
    if rec.launches_min is not None:
        out["launches_min"] = rec.launches_min
    eigval, eigvec = rec.eigval.double().to(s.y.device), rec.eigvec.double().to(s.y.device)
    own = s.own["eigval"]
    floor = torch.clamp(own, min=float(torch.median(own[1:])))
    out["eig_gap"] = float(torch.max(torch.abs(eigval - own)[1:] / floor[1:]))
    resid = ref_serve.basis_residuals(s.coeffs, eigval, eigvec)
    out["resid_max"] = float(torch.max(resid))
    out["eig_resid"] = float(torch.median(resid))
    out["ortho_off"] = ref_serve.orthonormality_gap(s.coeffs, eigvec)
    def post(val, vec):
        return ref_serve.posterior(s.coeffs, s.nbrs, s.y, val, vec, s.vals, config["nu"],
                                   config["bump_scale"], config["bump_decay"])

    def gaps(tag, prog, ref_mean, ref_var):
        out["mean_gap" + tag] = float(torch.max(torch.abs(prog[0] - ref_mean)[clear])
                                      / torch.max(torch.abs(ref_mean)))
        out["var_gap" + tag] = float(torch.max(torch.abs(prog[1] - ref_var)[clear])
                                     / torch.max(ref_var))

    gaps("", (rec.mean.double().to(s.y.device), rec.var.double().to(s.y.device)),
         *post(eigval, eigvec))
    j = ref_eigen.cluster_cut(s.own["ritz"], eigval.shape[0])
    gaps("_own", post(eigval[:j], eigvec[:, :j]), *post(own[:j], s.own["eigvec"][:, :j]))
    out["modes_own"] = j
    out["left_out"] = int((~clear).sum())
    return out


def judge(ref, record, cell, inputs, seed: int, device) -> dict:
    s = setting(ref, cell, inputs, seed, device)
    out = numbers(ref, s, cell, record)
    out["ref_passes"] = s.own["passes"]
    out["ref_resid_max"] = float(s.own["resid"].max())
    return out


def control(ref, record, cell, inputs, seed: int, device) -> dict:
    """The numbers of the control, the reference in ``limits/<cell>.json``'s
    "control" precision in the program's place (its graph from the points in
    that precision, its basis solved with the operator and operand stored in
    it, for as many passes as the float64 solve took, its posterior's
    products in it), and of planted faults in the program's output: half of
    the basis's vectors zeroed ("half"), one mode's vector duplicated into
    the next ("duplicated"), the modes above the wanted ones ("wrong_part",
    the reference's own m-th to 2m-th), a basis stopped early ("early", the
    reference's own solve after two passes), and one query point's mean
    altered by 1 % of the largest ("altered"). A stand-up served from
    another's cache reads 0 on launches_min."""
    config = cell.config
    precision = cell.limits["control"]
    s = setting(ref, cell, inputs, seed, device)
    low = setting(ref, cell, inputs, seed, device, precision=precision,
                  max_passes=s.own["passes"])
    eigval = ref_op.round_to(low.own["eigval"], precision)
    eigvec = ref_op.round_to(low.own["eigvec"], precision)
    mean, var = ref_serve.posterior(low.coeffs, low.nbrs, low.y, eigval, eigvec, low.vals,
                                    config["nu"], config["bump_scale"], config["bump_decay"],
                                    precision=precision)
    rows, cols = check.control_graph(ref, config["k"])
    xs, ts = (ref_op.round_to(torch.as_tensor(p, dtype=torch.float64, device=device),
                              precision) / ref.eps for p in (ref.raw_x, inputs.test_x_raw))
    _, query_idx = ref_serve.neighbours(xs, ts, config["k"])
    ctrl = ServeRecord(eigval=eigval, eigvec=eigvec, mean=mean, var=var, query_idx=query_idx,
                       graph_rows=rows, graph_cols=cols)
    m = record.eigval.shape[0]
    half = record.eigvec.clone()
    half[:, m // 2:] = 0.0
    duplicated = record.eigvec.clone()
    duplicated[:, 2] = duplicated[:, 1]
    xs = torch.as_tensor(ref.raw_x, dtype=torch.float64, device=device) / ref.eps
    above = ref_eigen.lowest(s.coeffs, xs, 2 * m, seed_int(seed, EIGEN_START))
    early = ref_eigen.lowest(s.coeffs, xs, m, seed_int(seed, EIGEN_START), max_passes=2)
    altered = record.mean.clone()
    altered[0] += 0.01 * torch.max(torch.abs(altered))
    faults = (
        ("control", ctrl),
        ("half", dataclasses.replace(record, eigvec=half)),
        ("duplicated", dataclasses.replace(record, eigvec=duplicated)),
        ("wrong_part", dataclasses.replace(record, eigval=above["eigval"][m:],
                                           eigvec=above["eigvec"][:, m:])),
        ("early", dataclasses.replace(record, eigval=early["eigval"], eigvec=early["eigvec"])),
        ("altered", dataclasses.replace(record, mean=altered)))
    return {name: numbers(ref, s, cell, r) for name, r in faults}
