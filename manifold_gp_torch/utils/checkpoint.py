"""Hyperparameter checkpointing (port of ``manifold_gp_tpu.utils.checkpoint``).

Only the (~5-scalar) hyperparameter state is checkpointed; the kNN graph and
eigenbasis are always recomputed. Everything is a plain ``.npz`` of numpy
arrays (no pickled objects): ``save_params`` / ``load_params`` for a params
dict, ``save_training_state`` / ``load_training_state`` for the full
resumable state of ``utils.train`` (params, Adam moments and step counts,
scheduler state, learning rate, epoch, and the states of the two random
generators). ``save_graph_cache`` / ``load_graph_cache`` keep a built graph
(edge list and ELL table) under a content fingerprint (``array_fingerprint``),
in the JAX package's file format (int32 indices).
"""

from __future__ import annotations

import hashlib
import json
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


def array_fingerprint(*arrays) -> str:
    """sha256 over each array's shape, dtype and bytes (the JAX package's
    fingerprint of the same numpy arrays)."""
    h = hashlib.sha256()
    for a in arrays:
        a = _np(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def save_graph_cache(graph, cache_dir, fingerprint: str):
    """Cache a built graph (edge list and ELL layout) as
    ``graph_{fingerprint}.npz``, indices as int32."""
    cache_dir = pathlib.Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        cache_dir / f"graph_{fingerprint}.npz",
        rows=_np(graph.rows).astype(np.int32),
        cols=_np(graph.cols).astype(np.int32),
        sqdist=_np(graph.sqdist).astype(np.float32),
        ell_edge=_np(graph.ell_edge).astype(np.int32),
        ell_col=_np(graph.ell_col).astype(np.int32),
        ell_mask=_np(graph.ell_mask).astype(np.float32),
        meta=np.asarray(
            json.dumps({"num_nodes": graph.num_nodes, "max_degree": graph.max_degree})
        ),
    )


def load_graph_cache(cache_dir, fingerprint: str, device="cuda"):
    """The graph saved by ``save_graph_cache`` (by either package) on
    ``device``, indices as int64; None when there is no such entry."""
    from ..ops.graph import SparseGraph

    device = resolve_device(device)
    path = pathlib.Path(cache_dir) / f"graph_{fingerprint}.npz"
    if not path.exists():
        return None
    with np.load(path) as d:
        meta = json.loads(str(d["meta"]))

        def idx(name):
            return torch.from_numpy(d[name].astype(np.int64)).to(device)

        return SparseGraph(
            rows=idx("rows"),
            cols=idx("cols"),
            sqdist=torch.from_numpy(d["sqdist"].astype(np.float32)).to(device),
            mask=torch.ones(d["rows"].shape[0], dtype=torch.float32, device=device),
            ell_edge=idx("ell_edge"),
            ell_col=idx("ell_col"),
            ell_mask=torch.from_numpy(d["ell_mask"].astype(np.float32)).to(device),
            num_nodes=meta["num_nodes"],
            max_degree=meta["max_degree"],
        )
