"""Carry a params dict between the JAX package and the port.

Both packages store the same raw (unconstrained) float32 scalars under the
same names (``raw_graphbandwidth``, ``raw_lengthscale``, ``raw_noise``,
``raw_outputscale``, ``mean_constant``), so conversion is a change of array
type only. The JAX side hands over numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict, device="cpu") -> dict:
    """{name: numpy array} (e.g. ``{k: np.asarray(v) for k, v in jax_params.items()}``)
    -> {name: float32 tensor on ``device``}."""
    return {
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in params_np.items()
    }


def params_to_numpy(params: dict) -> dict:
    """{name: tensor} -> {name: float32 numpy array}."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}
