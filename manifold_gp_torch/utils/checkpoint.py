"""Hyperparameter checkpointing (port of ``manifold_gp_tpu.utils.checkpoint``).

Only the (~5-scalar) hyperparameter state is checkpointed; the kNN graph and
eigenbasis are always recomputed. Everything is a plain ``.npz`` of numpy
arrays (no pickled objects): ``save_params`` / ``load_params`` for a params
dict, ``save_training_state`` / ``load_training_state`` for the full
resumable state of ``utils.train`` (params, Adam moments and step counts,
scheduler state, learning rate, epoch, and the states of the two random
generators).

Not ported yet: the graph-cache helpers.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..config import resolve_device

_SCALARS = ("epoch", "lr", "sched_best", "sched_num_bad", "sched_cooldown")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_params(params: dict, path):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: _np(v) for k, v in params.items()})


def load_params(path, device="cuda") -> dict:
    """The params dict saved by ``save_params``, as tensors on ``device``."""
    device = resolve_device(device)
    with np.load(path) as d:
        return {k: torch.tensor(d[k], device=device) for k in d.files}


def save_training_state(path, params, opt_state, epoch: int, lr, sched_state,
                        generator_state=None, callback_generator_state=None):
    """Full resumable training state. ``opt_state``: {param name: {"step",
    "exp_avg", "exp_avg_sq"}} (Adam); ``sched_state``: (best, num_bad,
    cooldown_counter); the generator states are ``torch.Generator.get_state()``
    byte tensors, or None when the run's randomness is passed in. Atomic
    write (tmp + rename)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"params/{k}": _np(v) for k, v in params.items()}
    for name, st in opt_state.items():
        for field, value in st.items():
            arrays[f"opt/{name}/{field}"] = _np(value)
    best, num_bad, cooldown = sched_state
    arrays.update(epoch=np.int64(epoch), lr=np.float64(lr), sched_best=np.float64(best),
                  sched_num_bad=np.int64(num_bad), sched_cooldown=np.int64(cooldown))
    if generator_state is not None:
        arrays["generator_state"] = _np(generator_state)
    if callback_generator_state is not None:
        arrays["callback_generator_state"] = _np(callback_generator_state)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)


def load_training_state(path, device="cuda"):
    """The state saved by ``save_training_state`` as a dict (``params`` and
    ``opt_state`` as tensors on ``device``, generator states as CPU byte
    tensors or None), or None when the file does not exist."""
    device = resolve_device(device)
    path = pathlib.Path(path)
    if not path.exists():
        return None
    state = {"params": {}, "opt_state": {}, "generator_state": None,
             "callback_generator_state": None}
    with np.load(path) as d:
        for key in d.files:
            parts = key.split("/")
            if parts[0] == "params":
                state["params"][parts[1]] = torch.tensor(d[key], device=device)
            elif parts[0] == "opt":
                # Adam keeps its step counts on the host
                state["opt_state"].setdefault(parts[1], {})[parts[2]] = torch.tensor(
                    d[key], device="cpu" if parts[2] == "step" else device)
            elif key in ("generator_state", "callback_generator_state"):
                state[key] = torch.tensor(d[key])
        state["epoch"] = int(d["epoch"])
        state["lr"] = float(d["lr"])
        state["sched_state"] = (float(d["sched_best"]), int(d["sched_num_bad"]),
                                int(d["sched_cooldown"]))
    return state
