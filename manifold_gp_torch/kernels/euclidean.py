"""Euclidean baseline kernels for the vanilla GP (port of
``manifold_gp_tpu.kernels.euclidean``).

  RBF:       k(r) = exp(-r^2 / (2 l^2))
  Matérn:    k(r) = exp(-r/l)                                  (nu = 1/2)
                    (1 + sqrt(3) r/l) exp(-sqrt(3) r/l)         (nu = 3/2)
                    (1 + sqrt(5) r/l + 5 r^2/(3 l^2)) exp(-sqrt(5) r/l)  (nu = 5/2)

The outputscale lives on the model side. Plain PyTorch: squared distances
by the JAX package's formula ||x||^2 + ||y||^2 - 2 x y' clamped at 0 (not
``torch.cdist``), so that the two packages round alike. The learnable
state is ``{"raw_lengthscale"}``, created on the kernel's device (the card
unless ``device="cpu"``).
"""

from __future__ import annotations

import math

import torch

from ..config import resolve_device
from ..parameters import ConstrainedParam, Positive


def sq_dists(x1, x2):
    n1 = torch.sum(x1 * x1, dim=-1)
    n2 = torch.sum(x2 * x2, dim=-1)
    d = n1[:, None] + n2[None, :] - 2.0 * (x1 @ x2.T)
    return torch.clamp(d, min=0.0)


class EuclideanKernel:
    has_lengthscale = True

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._param_decls = [ConstrainedParam("lengthscale", Positive())]

    def init_params(self, lengthscale=None) -> dict:
        return {"raw_lengthscale": self._param_decls[0].init_raw(lengthscale,
                                                                 device=self.device)}

    def lengthscale(self, params):
        return self._param_decls[0].value(params)

    def gram(self, params, x1, x2=None):
        raise NotImplementedError

    def gram_matvec(self, params, x1, v, x2=None, block_size: int = 4096):
        """K(x1, x2) @ v without the full gram matrix: one [block_size, n2]
        tile of kernel rows made at a time and contracted at once, so memory
        is O(block_size * n2) instead of O(n1 n2) and each product makes the
        tiles anew (the regime above ``cfg.dense_gram_max_size``)."""
        x2 = x1 if x2 is None else x2
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        out = torch.cat([self.gram(params, x1[i:i + block_size], x2) @ vv
                         for i in range(0, x1.shape[0], block_size)])
        return out[:, 0] if squeeze else out


class RBFKernel(EuclideanKernel):
    def gram(self, params, x1, x2=None):
        x2 = x1 if x2 is None else x2
        ls = self.lengthscale(params).reshape(())
        return torch.exp(-sq_dists(x1, x2) / (2.0 * ls * ls))


class MaternKernel(EuclideanKernel):
    """Half-integer Matérn; nu in {0.5, 1.5, 2.5}."""

    def __init__(self, nu: float = 2.5, device="cuda"):
        super().__init__(device=device)
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError(f"only half-integer Matérn is supported, got nu={nu}")
        self.nu = nu

    def gram(self, params, x1, x2=None):
        x2 = x1 if x2 is None else x2
        ls = self.lengthscale(params).reshape(())
        r = torch.sqrt(sq_dists(x1, x2) + 1e-20) / ls
        if self.nu == 0.5:
            return torch.exp(-r)
        if self.nu == 1.5:
            c = math.sqrt(3.0) * r
            return (1.0 + c) * torch.exp(-c)
        c = math.sqrt(5.0) * r
        return (1.0 + c + c * c / 3.0) * torch.exp(-c)
