"""Debug helpers (port of ``manifold_gp_tpu.utils.debug``; reference
``utils/torch_utils.py:19-35``: the live-tensor memory dump): a report of
the live tensors, the CUDA caching allocator's statistics per card, and a
non-finite guard over a nested structure of tensors."""

from __future__ import annotations

import gc
import warnings

import numpy as np
import torch


def live_arrays_report(top: int = 20) -> str:
    """Summary of the live tensors (a ``gc`` walk), largest first, with the
    CUDA caching allocator's allocated and reserved bytes per card when
    CUDA is initialised (the reference's ``memory_dump``)."""
    rows = []
    with warnings.catch_warnings():  # isinstance on deprecated module proxies warns
        warnings.simplefilter("ignore")
        tensors = [obj for obj in gc.get_objects() if isinstance(obj, torch.Tensor)]
    for obj in tensors:
        rows.append((obj.numel() * obj.element_size(), tuple(obj.shape),
                     str(obj.dtype).replace("torch.", ""), str(obj.device)))
    rows.sort(key=lambda r: r[0], reverse=True)
    total = sum(r[0] for r in rows)
    lines = [f"{len(rows)} live tensors, {total / 2**20:.1f} MiB total"]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            lines.append(f"  cuda:{d} allocator: {torch.cuda.memory_allocated(d) / 2**20:.1f} "
                         f"MiB allocated, {torch.cuda.memory_reserved(d) / 2**20:.1f} MiB "
                         "reserved")
    for nbytes, shape, dtype, device in rows[:top]:
        lines.append(f"  {nbytes / 2**20:8.2f} MiB  {dtype:>10} {shape} {device}")
    return "\n".join(lines)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each card, by device name ("cuda:0",
    ...); empty without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{d}": torch.cuda.memory_stats(d) for d in range(torch.cuda.device_count())}


def _leaves(tree, path=""):
    """(key path, leaf) pairs of nested dicts, lists and tuples; paths
    written as JAX's ``keystr`` writes them (``['a'][0]``)."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming every floating leaf (tensor or
    array) of ``tree`` that holds a non-finite value."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf.detach()).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
            if not np.isfinite(leaf).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
