"""Constrained-parameter transforms (port of ``manifold_gp_tpu.parameters``).

Every positive hyperparameter is an unconstrained "raw" float32 scalar in a
flat params dict, mapped through the same softplus / sigmoid transforms as
the JAX package, so the two packages' params dicts carry over unchanged
(``utils.convert.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    # Numerically-stable inverse of softplus: x = y + log(1 - exp(-y)).
    return y + torch.log(-torch.expm1(-y))


@dataclasses.dataclass(frozen=True)
class Interval:
    """Base constraint: value = lower + (upper-lower)*sigmoid(raw)."""

    lower_bound: float = -np.inf
    upper_bound: float = np.inf

    def transform(self, raw):
        return self.lower_bound + (self.upper_bound - self.lower_bound) * (
            1.0 / (1.0 + torch.exp(-raw))
        )

    def inverse_transform(self, value):
        t = (value - self.lower_bound) / (self.upper_bound - self.lower_bound)
        return torch.log(t) - torch.log1p(-t)


@dataclasses.dataclass(frozen=True)
class GreaterThan:
    """value = softplus(raw) + lower_bound (matches GPyTorch's default)."""

    lower_bound: float = 0.0

    def transform(self, raw):
        return softplus(raw) + self.lower_bound

    def inverse_transform(self, value):
        return inv_softplus(value - self.lower_bound)


class Positive(GreaterThan):
    def __init__(self):
        super().__init__(lower_bound=0.0)


@dataclasses.dataclass(frozen=True)
class ConstrainedParam:
    """Declaration of one learnable scalar (or small-array) hyperparameter."""

    name: str
    constraint: GreaterThan | Interval
    init_value: float = 1.0
    shape: tuple = ()

    @property
    def raw_name(self) -> str:
        return "raw_" + self.name

    def init_raw(self, value: Optional[float] = None, device="cpu"):
        v = self.init_value if value is None else value
        raw = self.constraint.inverse_transform(
            torch.as_tensor(v, dtype=torch.float32, device=device)
        )
        return raw.expand(self.shape).to(torch.float32).clone()

    def value(self, params):
        return self.constraint.transform(params[self.raw_name])
