"""Pieces the port's reference-protocol scripts share (``run_rmnist.py``,
``run_1d.py``, ``run_2d.py``, ``eval_pretrained.py``, ``run_spiral.py``):
the reference notebooks' seed-1337 split, drawn on the CPU; the data-driven
bandwidth recipe of notebook cell "74cd3ae2"; the kernels' launch counters
by batch width; the epoch clock and the CG iteration summary.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np


def reference_split(n: int, count: int, seed: int = 1337):
    """The notebooks' split: ``torch.manual_seed(seed)``, then the scatter of
    ``randperm(n)[:count]`` into a boolean mask. Returns (mask [n] numpy
    bool, generator): the notebooks draw the label noise next from the same
    CPU generator (``label_noise``). The draws stay on the CPU whatever
    device the model runs on: a CUDA generator gives other numbers."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=gen)[:count]
    return torch.zeros(n).scatter_(0, perm, 1).bool().numpy(), gen


def label_noise(generator, m: int, scale: float = 0.01) -> np.ndarray:
    """``scale * torch.randn(m)`` from the split's CPU generator, as numpy f32."""
    import torch

    return scale * torch.randn(m, generator=generator).numpy()


def normalize_labels(train_y, *others):
    """y-normalization on the labeled subset (``normalize_y=True``):
    (train_y, *others) shifted by train_y's mean and divided by its sd."""
    mu, sd = train_y.mean(), train_y.std(ddof=1)
    return tuple((y - mu) / sd for y in (train_y, *others))


def knn_bandwidth(train_x, device, k: int = 10):
    """(graphbandwidth_min, median mean-kNN distance) of notebook cell
    "74cd3ae2", from the port's kNN search on ``device`` (self excluded)."""
    import torch

    from manifold_gp_torch.ops.knn import knn_search

    xt = torch.as_tensor(train_x, dtype=torch.float32, device=device)
    ev = knn_search(xt, xt, k, self_query=True)[0][:, 1:].cpu().numpy()
    gb_min = math.sqrt(float(ev[:, 0].max()) / (-4.0 * math.log(1e-4)))
    mean_knn = np.sort(np.sqrt(ev).mean(axis=1))
    median = float(mean_knn[int(round(ev.shape[0] * 0.5))])
    return gb_min, median


def bandwidth_prior(gb_min: float, median: float):
    """The cell's Gamma prior: its mode sits at the median kNN distance."""
    from manifold_gp_torch import GammaPrior

    rate = 4.0 * median / (median - gb_min) ** 2
    return GammaPrior(rate * median + 1.0, rate)


def reset_launch_counts():
    from manifold_gp_torch.ops import cuda_spmv, dia

    cuda_spmv.launch_count = cuda_spmv.bwd_launch_count = 0
    cuda_spmv.launch_count_by_batch.clear()
    cuda_spmv.bwd_launch_count_by_batch.clear()
    dia.dia_launch_count = 0


def launch_snapshot() -> dict:
    """The kernels' launches since the last reset: the forward block-ELL
    SpMV and the panel cotangent K3, each also by batch width, and K4."""
    from manifold_gp_torch.ops import cuda_spmv, dia

    return {
        "forward": cuda_spmv.launch_count, "bwd_blocks": cuda_spmv.bwd_launch_count,
        "forward_by_batch": {str(b): c for b, c in
                             sorted(cuda_spmv.launch_count_by_batch.items())},
        "bwd_blocks_by_batch": {str(b): c for b, c in
                                sorted(cuda_spmv.bwd_launch_count_by_batch.items())},
        "dia": dia.dia_launch_count,
    }


def device_clock(cuda: bool):
    """A host clock that first waits for the card's queue when ``cuda``."""
    import torch

    def clock():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    return clock


class EpochClock:
    """``metrics`` hook of the training loops: the host clock at the end of
    every epoch (each epoch reads its loss back, so the clock follows the
    device), and the device memory still allocated then (flat from epoch
    to epoch when no epoch's autograd graph outlives it)."""

    def __init__(self, cuda: bool):
        import torch

        self.allocated = torch.cuda.memory_allocated if cuda else (lambda: None)
        self.stamps = [time.perf_counter()]
        self.bytes = []

    def record(self, epoch, **values):
        self.stamps.append(time.perf_counter())
        self.bytes.append(self.allocated())

    def epoch_seconds(self):
        return [b - a for a, b in zip(self.stamps, self.stamps[1:])]


def cg_summary(iters):
    if not iters:
        return {"solves": 0}
    return {"solves": len(iters), "mean": statistics.fmean(iters), "max": max(iters),
            "total": sum(iters)}

