#!/usr/bin/env python3
"""Where one training gradient of the campaign spends its time on the card
(and, with ``profile_basis``, one spectral-basis solve).

Builds the campaign (``run_large.build_campaign`` on the torus or the curve)
and its preconditioner (``--precond``: Jacobi, or the campaign's pivoted
Cholesky, built once outside the traced gradient and passed in, as a
``precond_refresh`` epoch uses it), takes one ``mll_loss`` gradient to warm
up (kernel build, cuSOLVER handles), then traces a second one with
``torch.profiler`` and prints one JSON line:
the wall time of the traced gradient, the summed device time of every kernel
and memcpy, the device's busy and idle share of the wall time, and the
largest kernels by device time with their launch counts.

  python examples_torch/profile_gradient.py --n 262144              # initial hyperparameters
  python examples_torch/profile_gradient.py --n 262144 --trained    # where CG runs long
  python examples_torch/profile_gradient.py --n 262144 --manifold curve   # DIA bands, K4
  python examples_torch/profile_gradient.py --n 262144 --trained --precond pivchol
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from examples_torch.run_large import (  # noqa: E402
    INITIAL_HYPERS,
    MANIFOLDS,
    build_campaign,
    build_precond,
    loss_and_grad,
)


def trace_gradient(model, params, generator=None, precond_override=None, probes=None,
                   top: int = 12) -> dict:
    """Trace one ``mll_loss`` gradient of ``model`` (after a warm-up one)
    with ``torch.profiler``: the loss, the wall ms, the summed device ms of
    every kernel and memcpy, the device's busy and idle share of the wall
    time, and the ``top`` kernels by device time with their launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(generator=generator, precond_override=precond_override, probes=probes)
    loss_and_grad(model, params, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = loss_and_grad(model, params, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {
        "loss": loss,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "kernels": [{"name": k[:80], "device_ms": ms, "share_of_wall": ms / wall_ms,
                     "launches": c} for k, ms, c in rows[:top]],
    }


def profile_gradient(n: int, trained: bool, top: int = 12, manifold: str = "torus",
                     precond: str = "jacobi") -> dict:
    import torch

    camp = build_campaign(n=n, device="cuda", manifold=manifold, precond_type=precond)
    model = camp.model
    params = model.init_params(**(MANIFOLDS[manifold]["hypers"] if trained else INITIAL_HYPERS))
    pobj, build_s, _ = build_precond(model, params, precond)
    generator = torch.Generator(device=model.device).manual_seed(1)
    return {
        "n": n,
        "manifold": manifold,
        "hyperparameters": "trained" if trained else "initial",
        "precond": precond,
        "precond_build_s": build_s,
        "device": torch.cuda.get_device_name(0),
        **trace_gradient(model, params, generator=generator, precond_override=pobj, top=top),
    }


# aten ops whose device time (their kernels included) is the basis solve's
# dense linear algebra, by kind
_BASIS_OPS = {
    "gemm": ("aten::mm", "aten::addmm", "aten::bmm"),
    "eigh_qr_svd": ("aten::linalg_eigh", "aten::linalg_qr", "aten::_linalg_svd"),
}


def profile_basis(kernel, params) -> dict:
    """Trace one ``eval_basis`` of ``kernel`` (on the card) with
    ``torch.profiler``: wall ms, device ms split into the forward SpMV
    kernel (by kernel name), GEMMs and cuSOLVER ``eigh``/``qr``/``svd`` (by
    the aten op that launched them, its kernels included) and the rest,
    and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        type(kernel).eval_basis(kernel, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in device) / 1e3
    spmv = [e for e in device if "block_ell_spmv" in e.key]
    split = {"spmv_kernel": sum(e.device_time_total for e in spmv) / 1e3}
    for kind, names in _BASIS_OPS.items():
        split[kind] = sum(e.device_time_total for e in events
                          if e.device_type == torch.autograd.DeviceType.CPU
                          and e.key in names) / 1e3
    split["other_device"] = device_ms - sum(split.values())
    top = sorted(device, key=lambda e: -e.device_time_total)[:12]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "device_ms_by_kind": split,
        "spmv_launches": sum(e.count for e in spmv),
        "top_kernels": [{"name": e.key[:80], "device_ms": e.device_time_total / 1e3,
                         "launches": e.count} for e in top],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--trained", action="store_true",
                    help="the campaign's trained hyperparameters instead of the initial ones")
    ap.add_argument("--manifold", choices=sorted(MANIFOLDS), default="torus")
    ap.add_argument("--precond", choices=("jacobi", "pivchol"), default="jacobi")
    args = ap.parse_args()
    print(json.dumps(profile_gradient(args.n, args.trained, manifold=args.manifold,
                                      precond=args.precond)))


if __name__ == "__main__":
    main()
