"""Hyperpriors over constrained hyperparameters (port of
``manifold_gp_tpu.priors``).

Priors are plain log-density functions over the *constrained* value — the
training loss subtracts their log-prob. Not ported yet: ``sample`` (its one
caller, the multi-start trainer, waits for 'Large-N ancillaries').
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GammaPrior:
    """Gamma(concentration, rate) over a positive hyperparameter."""

    concentration: float
    rate: float

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * math.log(b) - math.lgamma(a) + (a - 1.0) * torch.log(value) - b * value


@dataclasses.dataclass(frozen=True)
class InverseGammaPrior:
    """InverseGamma(concentration, rate): X~Gamma(a,b) => 1/X~InvGamma(a,b).

      log p(y) = a log b - lgamma(a) - (a+1) log y - b / y
    """

    concentration: float
    rate: float

    def log_prob(self, value):
        a, b = self.concentration, self.rate
        return a * math.log(b) - math.lgamma(a) - (a + 1.0) * torch.log(value) - b / value


@dataclasses.dataclass(frozen=True)
class NormalPrior:
    loc: float
    scale: float

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - math.log(self.scale) - 0.5 * math.log(2 * math.pi)


def data_driven_bandwidth_prior(edge_sqdists):
    """The data-driven Gamma prior over graphbandwidth.

    Given squared distances to the k nearest non-self neighbors (shape [N, k]),
    computes (graphbandwidth_min, GammaPrior):
      eps_min   = sqrt(max_i d_{i,1}^2 / (-4 ln 1e-4))
      median    = median over i of mean_j sqrt(d_{ij}^2)
      rate      = 4 median / (median - eps_min)^2
      concentr. = rate * median + 1
    """
    if isinstance(edge_sqdists, torch.Tensor):
        edge_sqdists = edge_sqdists.detach().cpu().numpy()
    d = np.asarray(edge_sqdists, np.float32)
    eps_min = np.sqrt(d[:, 0].max() / np.float32(-4.0 * math.log(1e-4)))
    mean_dist = np.sqrt(d).mean(axis=1)
    sorted_md = np.sort(mean_dist)
    median = sorted_md[int(round(d.shape[0] * 0.50))]
    rate = np.float32(4.0) * median / (median - eps_min) ** 2
    concentration = rate * median + np.float32(1.0)
    return float(eps_min), GammaPrior(float(concentration), float(rate))
