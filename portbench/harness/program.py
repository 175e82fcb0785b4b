"""The system under test, built through the port's public API from a
configuration file and the seed's data: the exact kNN graph on the device
(``ops.graph.build_graph``), the campaign's unit-bandwidth rescale and
bandwidth floor, ``RiemannMaternKernel`` and ``RiemannGP`` with the
configuration's ``InferenceConfig``."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import data


QUERIES = 3  # seed tag of the posterior's query points


@dataclasses.dataclass
class Inputs:
    """The run's inputs: the configuration's training sample and labels
    (from its ``data_seed``), the query points (from the run's seed), and
    the coordinate scale and bandwidth floor the campaign sets up from the
    port's graph."""

    test_x: np.ndarray  # the query points, rescaled to unit bandwidth
    train_y: np.ndarray
    train_x_raw: np.ndarray  # as sampled
    test_x_raw: np.ndarray
    eps: float
    gb_floor: float


def seed_int(seed: int, *tags: int) -> int:
    """A 63-bit integer from the run's seed and tags (for torch generators
    and per-job draws)."""
    words = [int(seed) % (1 << 63), *[int(t) for t in tags]]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(config: dict, seed: int, device, spans: dict):
    """(model, inputs): the port's model of ``config`` on its training
    sample, with query points from ``seed``. ``spans["graph_s"]``: host
    seconds of the graph build, ending in a device synchronize."""
    import torch

    from manifold_gp_torch import InferenceConfig, RiemannGP, RiemannMaternKernel
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.parameters import GreaterThan

    train_x, _, train_y, _, _, _ = data.campaign_data(
        config["n"], config["num_test"], config["data_seed"], config["manifold"])
    test_x = data.query_points(config["manifold"], config["num_test"], seed_int(seed, QUERIES))
    k = config["k"]
    sync(device)
    t0 = time.perf_counter()
    graph = build_graph(train_x, k, knn_backend=config["knn_backend"], device=device)
    sync(device)
    spans["graph_s"] = time.perf_counter() - t0
    eps = data.unit_bandwidth(graph.sqdist.cpu().numpy())
    # divide by a device tensor: true f32 division, as the campaign does
    eps2 = torch.tensor(np.float32(eps) ** 2, device=device)
    graph = dataclasses.replace(graph, sqdist=graph.sqdist / eps2)
    gb_floor = data.bandwidth_floor(graph.rows.cpu().numpy(), graph.cols.cpu().numpy(),
                                    graph.sqdist.cpu().numpy(), train_x.shape[0])
    cfg = InferenceConfig(**config["inference"])
    train_x_s, test_x_s = train_x / eps, test_x / eps
    kernel = RiemannMaternKernel(
        nu=config["nu"], x=train_x_s, nearest_neighbors=k,
        laplacian_normalization=config["laplacian_normalization"],
        num_modes=config["num_modes"], bump_scale=config["bump_scale"],
        bump_decay=config["bump_decay"], cfg=cfg, graph=graph,
        graphbandwidth_constraint=GreaterThan(gb_floor), device=device)
    sync(device)
    model = RiemannGP(train_x_s, train_y, kernel, cfg=cfg)
    return model, Inputs(test_x=test_x_s, train_y=train_y,
                         train_x_raw=train_x, test_x_raw=test_x, eps=eps, gb_floor=gb_floor)


def layout_spec(model) -> dict:
    """The operator layout's sizes, for the roofline counts."""
    layout = model.kernel.block_layout
    if hasattr(layout, "offsets"):
        return {"format": "dia", "num_padded": int(layout.num_padded),
                "num_offsets": int(layout.num_offsets)}
    return {"format": "block", "nrb": int(layout.num_row_blocks),
            "s_max": int(layout.max_blocks), "num_padded": int(layout.num_padded)}


def counters() -> dict:
    """The port's launch counters: the forward kernel's and K3's by batch
    width, K4's total."""
    from manifold_gp_torch.ops import cuda_spmv, dia

    return {"fwd": dict(cuda_spmv.launch_count_by_batch),
            "k3": dict(cuda_spmv.bwd_launch_count_by_batch),
            "k4": int(dia.dia_launch_count)}


def counters_since(before: dict) -> dict:
    now = counters()
    out = {}
    for key in ("fwd", "k3"):
        out[key] = {b: c - before[key].get(b, 0) for b, c in now[key].items()
                    if c != before[key].get(b, 0)}
    out["k4"] = now["k4"] - before["k4"]
    return out
