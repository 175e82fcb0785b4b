"""Carry a params dict between the JAX package and the port.

Both packages store the same raw (unconstrained) float32 scalars under the
same names (``raw_graphbandwidth``, ``raw_lengthscale``, ``raw_noise``,
``raw_outputscale``, ``mean_constant``), so conversion is a change of array
type only, as long as both models declare the same constraints. The raw
value of a parameter depends on its constraint (``GreaterThan(gb_min)``
shifts the bandwidth by its floor before the inverse softplus), so between
models whose constraints differ the state travels as constrained values:
``constrained_values`` / ``params_from_constrained``. The JAX side hands
over numpy arrays; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def params_from_jax(params_np: dict, device="cuda") -> dict:
    """{name: numpy array} (e.g. ``{k: np.asarray(v) for k, v in jax_params.items()}``)
    -> {name: float32 tensor on ``device``}."""
    device = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in params_np.items()
    }


def params_to_numpy(params: dict) -> dict:
    """{name: tensor} -> {name: float32 numpy array}."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}


_DECLS = (
    ("graphbandwidth", lambda m: m.kernel._decl("graphbandwidth")),
    ("lengthscale", lambda m: m.kernel._decl("lengthscale")),
    ("noise", lambda m: m._noise_decl),
    ("outputscale", lambda m: m._outputscale_decl),
)


def constrained_values(model, params: dict) -> dict:
    """{name: float} of the constrained hyperparameters under ``model``'s own
    constraints (plus ``mean_constant``)."""
    out = {
        name: float(decl(model).value(params).detach().reshape(()))
        for name, decl in _DECLS
        if decl(model).raw_name in params
    }
    out["mean_constant"] = float(params["mean_constant"].detach())
    return out


def params_from_constrained(model, values: dict) -> dict:
    """The raw params dict of ``model`` (fresh leaf tensors on its device,
    no optimizer state) that takes the given constrained values under
    ``model``'s own constraints: the inverse of ``constrained_values``."""
    return model.init_params(
        noise=values["noise"], outputscale=values.get("outputscale"),
        graphbandwidth=values["graphbandwidth"], lengthscale=values["lengthscale"],
        mean_constant=values.get("mean_constant", 0.0),
    )
