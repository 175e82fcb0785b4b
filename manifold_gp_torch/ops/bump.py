"""Compactly-supported bump function (port of ``manifold_gp_tpu.ops.bump``):

  bump(x; alpha, beta) = exp(beta/(x^2 - alpha^2)) / exp(-beta/alpha^2)

for |x| < alpha, and 0 outside, written with a safe denominator so it is
finite and differentiable everywhere.
"""

from __future__ import annotations

import torch


def bump_function(x, alpha, beta):
    x = torch.as_tensor(x)
    inside = torch.abs(x) < alpha
    denom = torch.where(inside, x * x - alpha * alpha, torch.full_like(x, -1.0))
    val = torch.exp(beta / denom + beta / (alpha * alpha))
    return torch.where(inside, val, torch.zeros_like(val))
