"""What every output check shares: the reference's own set-up from the run's
inputs, the graph comparison, the signed per-leaf gap, the control's graph
and the verdict of numbers against their limits. Each kind of traffic
(``portbench/loops/<kind>.py``) judges its own outputs with these.

  graph_edges_off  edges of the program's graph not in the reference's kNN
                   graph, or the other way round, per reference edge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference import graph as ref_graph
from ..reference import operator as ref_op
from . import data


@dataclasses.dataclass
class Reference:
    """The reference's own graph and set-up from the run's inputs."""

    graph: ref_op.Graph
    eps: float
    gb_floor: float
    raw_x: np.ndarray


def reference_setup(raw_train_x: np.ndarray, k: int, device) -> Reference:
    rows, cols, sqd = ref_graph.knn_graph(raw_train_x, k, device)
    eps = data.unit_bandwidth(sqd.cpu().numpy())
    sqd = sqd / eps ** 2
    floor = data.bandwidth_floor(rows.cpu().numpy(), cols.cpu().numpy(), sqd.cpu().numpy(),
                                 raw_train_x.shape[0])
    return Reference(ref_op.Graph(rows, cols, sqd, raw_train_x.shape[0]), eps, floor,
                     raw_train_x)


def edges_off(ref: Reference, rows, cols) -> float:
    g = ref.graph
    off = ref_graph.edge_mismatch(rows, cols, g.rows.cpu().numpy(), g.cols.cpu().numpy(), g.n)
    return off / g.rows.shape[0]


def differing_nodes(ref: Reference, rows, cols) -> torch.Tensor:
    """[n] bool: the endpoints of the edges in one graph and not the other
    (their degrees differ between the program and the reference)."""
    g = ref.graph
    a = np.asarray(rows, np.int64) * g.n + np.asarray(cols, np.int64)
    b = g.rows.cpu().numpy() * g.n + g.cols.cpu().numpy()
    diff = np.setxor1d(np.unique(a), np.unique(b), assume_unique=True)
    out = torch.zeros(g.n, dtype=torch.bool, device=g.rows.device)
    ends = torch.as_tensor(np.concatenate([diff // g.n, diff % g.n]), device=out.device)
    out[ends] = True
    return out


def f64(raw: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float64).to(device).reshape(())
            for k, v in raw.items()}


def leaf_gap(prog: dict, ref: dict, counted) -> float:
    """The worst leaf's |prog - ref| / max(|ref|, median |ref|), signed
    values compared: a leaf of the wrong sign reads about 2."""
    mags = {k: abs(float(ref[k])) for k in counted}
    median = float(np.median(list(mags.values())))
    return max(abs(float(prog[k]) - float(ref[k])) / max(mags[k], median) for k in counted)


def control_graph(ref: Reference, k: int) -> tuple:
    """The control's graph: the reference's kNN search on the points stored
    in TF32, the next precision below the search's float32."""
    x = ref_op.round_to(torch.as_tensor(ref.raw_x, dtype=torch.float64,
                                        device=ref.graph.rows.device), "tf32")
    rows, cols, _ = ref_graph.knn_graph(x.cpu().numpy(), k, ref.graph.rows.device)
    return rows.cpu().numpy(), cols.cpu().numpy()


STATED = {"bfloat16": "bf16", "float32": "f32"}  # spmv_dtype -> the reference's storage


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit, sense)]): each number that has a
    limit within it ("max": at most; "min": at least). A limit without a
    number fails; a number without a limit is reported, not compared."""
    rows, ok = [], True
    for name, lim in limits.items():
        sense, bound = next(iter(lim.items()))
        value = numbers.get(name)
        good = value is not None and np.isfinite(value) and (
            value <= bound if sense == "max" else value >= bound)
        ok = ok and good
        rows.append((name, value, bound, sense))
    return ok, rows
