#!/usr/bin/env python3
"""2-D dragon-mesh experiment with the PyTorch port: the port's copy of
``examples/run_2d.py``.

The reference ships the Stanford-dragon loader (``load_dataset.py:21-25,
109-145``, y = 2 sin(geodesic + 0.3)) and the decimated mesh but no
notebook; this runs the 1-D notebooks' protocol on it: the mesh in
unit-bounding-box coordinates (the raw mm-scale STL drives the nu-fold
precision past f32 range), ``num_test`` held-out vertices by the seed-1337
split drawn on the CPU, label noise 0.01, y normalized, the data-driven
Gamma bandwidth prior with the bandwidth initialised at twice the median
kNN distance, nu = 1, k = 10, 100 modes, Adam at 1e-1 with weight decay
1e-8 for 100 epochs; then a vanilla RBF GP (BBMM: 4,882 > max_cholesky).

On all 4,882 training vertices the graph takes the block-ELL layout:
training runs the forward kernel at the probe width and at B = 1 and the
panel-cotangent kernel K3; the basis is a dense ``eigh`` (4,882 <=
``eigh_max_size``).

Usage:
  python examples_torch/run_2d.py                      # CUDA
  python examples_torch/run_2d.py --max-iter 3 --cpu
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def run_experiment(max_iter: int = None, num_test: int = 100, device="cuda",
                   verbose: bool = False, vanilla_max_iter: int = None,
                   handles: dict = None) -> dict:
    """The protocol end to end; returns the result record. The vanilla GP
    trains for ``vanilla_max_iter`` epochs (default: as many as IMGP).
    ``handles``: a dict that receives the trained IMGP ``model`` and
    ``params``."""
    import torch

    from manifold_gp_torch import (
        GreaterThan,
        InferenceConfig,
        RBFKernel,
        RiemannGP,
        RiemannMaternKernel,
        VanillaGP,
        resolve_device,
    )
    from manifold_gp_torch.ops import cg
    from manifold_gp_torch.utils import (
        manifold_2D_dataset,
        manifold_informed_train,
        test_model,
        vanilla_train,
    )

    from examples_torch import reference_protocol as rp

    device = resolve_device(device)
    cuda = device.type == "cuda"
    clock = rp.device_clock(cuda)
    sampled_x, sampled_y = manifold_2D_dataset()
    sampled_x = sampled_x / (sampled_x.max(0) - sampled_x.min(0)).max()
    n = sampled_x.shape[0]
    test_idx, gen = rp.reference_split(n, num_test)
    train_x, test_x = sampled_x[~test_idx], sampled_x[test_idx]
    train_y, test_y = sampled_y[~test_idx], sampled_y[test_idx]
    train_y = train_y + rp.label_noise(gen, train_y.shape[0])
    train_y, test_y = rp.normalize_labels(train_y, test_y)

    cfg = InferenceConfig(max_cholesky=2000, cg_tolerance=1e-2, cg_max_iter=1000)
    t0 = clock()
    gb_min, median = rp.knn_bandwidth(train_x, device)
    kernel = RiemannMaternKernel(
        nu=1, x=train_x, nearest_neighbors=10, laplacian_normalization="randomwalk",
        num_modes=100, bump_scale=10.0, bump_decay=1.0,
        graphbandwidth_prior=rp.bandwidth_prior(gb_min, median), cfg=cfg, device=device,
    )
    model = RiemannGP(train_x, train_y, kernel, noise_constraint=GreaterThan(1e-8), cfg=cfg)
    graph_s = clock() - t0
    layout = kernel.block_layout
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=2.0 * median,
                               lengthscale=1.0)

    rp.reset_launch_counts()
    cg.iteration_log = []
    epochs = rp.EpochClock(cuda)
    t0 = clock()
    try:
        params, loss, history = manifold_informed_train(
            model, params, lr=1e-1, weight_decay=1e-8, max_iter=max_iter or 100,
            tolerance=1e-2, num_rand_vec=100, verbose=verbose, metrics=epochs,
        )
        train_s = clock() - t0
        train_log = cg.iteration_log
    finally:
        cg.iteration_log = None
    train_launches = rp.launch_snapshot()
    print(f"[manifold] final loss {loss:.4f} ({train_s:.1f}s)", file=sys.stderr)
    t0 = clock()
    rmse, nll = test_model(model, params, test_x, test_y, noisy_test=True)
    eval_s = clock() - t0
    if handles is not None:
        handles.update(model=model, params=params)

    t0 = clock()
    vmodel = VanillaGP(train_x, train_y, RBFKernel(device=device), cfg=cfg)
    vparams = vmodel.init_params(noise=1e-2, outputscale=1.0, lengthscale=0.5)
    vparams, _, _ = vanilla_train(vmodel, vparams, lr=1e-1, weight_decay=1e-8,
                                  max_iter=vanilla_max_iter or max_iter or 100, tolerance=1e-2,
                                  verbose=verbose)
    vrmse, vnll = test_model(vmodel, vparams, test_x, test_y, noisy_test=True)
    vanilla_s = clock() - t0
    epoch_s = epochs.epoch_seconds()
    return {
        "device": str(device),
        "n": n,
        "num_train": int(train_x.shape[0]),
        "layout": type(layout).__name__ if layout is not None else "dense",
        "max_blocks": getattr(layout, "max_blocks", None),
        "num_row_blocks": getattr(layout, "num_row_blocks", None),
        "imgp_loss": loss,
        "loss_history": [float(v) for v in history],
        "imgp_rmse": rmse,
        "imgp_nll": nll,
        "vanilla_rmse": vrmse,
        "vanilla_nll": vnll,
        "params_finite": all(bool(torch.isfinite(v).all()) for v in params.values()),
        "hypers": {name: float(fn(params).detach()) for name, fn in (
            ("noise", model.noise), ("outputscale", model.outputscale),
            ("graphbandwidth", kernel.graphbandwidth), ("lengthscale", kernel.lengthscale))},
        "graph_s": graph_s,
        "train_s": train_s,
        "loss_evaluations": len(epoch_s),
        "epoch_s_median": statistics.median(epoch_s),
        "eval_s": eval_s,
        "vanilla_s": vanilla_s,
        "train_launches": train_launches,
        "cg": rp.cg_summary([it for _, _, _, it in train_log]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU instead of CUDA")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--num-test", type=int, default=100)
    args = ap.parse_args()
    r = run_experiment(max_iter=args.max_iter, num_test=args.num_test,
                       device="cpu" if args.cpu else "cuda", verbose=args.verbose)
    print(f"RMSE Geometric: {r['imgp_rmse']:.4f}")
    print(f"NLL Geometric: {r['imgp_nll']:.4f}")
    print(f"RMSE Vanilla: {r['vanilla_rmse']:.4f}")
    print(f"NLL Vanilla: {r['vanilla_nll']:.4f}")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
