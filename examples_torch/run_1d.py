#!/usr/bin/env python3
"""1-D dumbbell experiments (supervised and semisupervised) with the
PyTorch port: the port's copy of ``examples/run_1d.py``.

Replicates the reference notebooks ``1D_supervised_learning.ipynb`` and
``1D_semisupervised_learning.ipynb``: the seed-1337 split drawn on the CPU
(10 nodes: the test set when supervised, the labeled set when
semisupervised), label noise 0.01, y normalized on the training labels,
nu = 1, k = 10, 50 modes, and the JAX example's stable-basin inits
(bandwidth 0.05; lengthscale 6 when semisupervised) and data-driven Gamma
bandwidth prior (supervised only; ``--no-gb-prior`` drops it). Then a
vanilla RBF GP on the same training points. At 1,556 nodes everything is
dense: no kernel launches.

Usage:
  python examples_torch/run_1d.py supervised            # CUDA
  python examples_torch/run_1d.py semisupervised --max-iter 3 --cpu
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def run_experiment(mode: str, max_iter: int = None, device="cuda", gb_init: float = None,
                   ls_init: float = None, gb_prior: bool = True,
                   verbose: bool = False) -> dict:
    from manifold_gp_torch import (
        GreaterThan,
        InferenceConfig,
        RBFKernel,
        RiemannGP,
        RiemannMaternKernel,
        VanillaGP,
        resolve_device,
    )
    from manifold_gp_torch.utils import (
        ReduceLROnPlateau,
        manifold_1D_dataset,
        manifold_informed_train,
        test_model,
        vanilla_train,
    )

    from examples_torch import reference_protocol as rp

    semisup = mode == "semisupervised"
    device = resolve_device(device)
    clock = rp.device_clock(device.type == "cuda")
    sampled_x, sampled_y, _ = manifold_1D_dataset()
    n = sampled_x.shape[0]
    picked, gen = rp.reference_split(n, 10)
    if semisup:
        # the 10 drawn nodes are the labeled set, the graph covers all nodes
        labeled = picked
        train_x, train_y = sampled_x[labeled], sampled_y[labeled]
        test_x, test_y = sampled_x[~labeled], sampled_y[~labeled]
    else:
        labeled = None
        train_x, test_x = sampled_x[~picked], sampled_x[picked]
        train_y, test_y = sampled_y[~picked], sampled_y[picked]
    train_y = train_y + rp.label_noise(gen, train_y.shape[0])
    train_y, test_y = rp.normalize_labels(train_y, test_y)

    cfg = InferenceConfig(max_cholesky=2000, cg_tolerance=1e-2, cg_max_iter=1000)
    # the data-driven bandwidth prior (cell "74cd3ae2"), supervised only: on
    # 10 labeled points the kNN-median heuristic is meaningless
    prior = None
    if gb_prior and not semisup:
        prior = rp.bandwidth_prior(*rp.knn_bandwidth(train_x, device))
    kernel = RiemannMaternKernel(
        nu=1, x=sampled_x if semisup else train_x, nearest_neighbors=10,
        laplacian_normalization="randomwalk", num_modes=50, bump_scale=10.0,
        bump_decay=1.0, graphbandwidth_prior=prior, cfg=cfg, device=device,
    )
    model = RiemannGP(train_x, train_y, kernel, labeled=labeled,
                      noise_constraint=GreaterThan(1e-8), cfg=cfg)
    gb0 = 0.05 if gb_init is None else gb_init
    ls0 = (6.0 if semisup else 1.0) if ls_init is None else ls_init
    params = model.init_params(noise=1e-2, outputscale=1.0, graphbandwidth=gb0,
                               lengthscale=ls0)

    epochs = rp.EpochClock(device.type == "cuda")
    t0 = clock()
    if semisup:
        params, loss, _ = manifold_informed_train(
            model, params, lr=1e-1, weight_decay=0.0, max_iter=max_iter or 500,
            tolerance=1e-2, update_norm=100, num_rand_vec=100,
            scheduler=ReduceLROnPlateau(factor=0.5, patience=50, threshold=1e-3),
            verbose=verbose, metrics=epochs,
        )
    else:
        params, loss, _ = manifold_informed_train(
            model, params, lr=1e-1, weight_decay=1e-8, max_iter=max_iter or 100,
            tolerance=1e-2, num_rand_vec=100, verbose=verbose, metrics=epochs,
        )
    train_s = clock() - t0
    print(f"[manifold] final loss {loss:.4f} ({train_s:.1f}s)", file=sys.stderr)
    rmse, nll = test_model(model, params, test_x, test_y, noisy_test=True)

    # vanilla baseline: ScaleKernel(RBF), lengthscale init 0.5 supervised /
    # 1.0 semisupervised (the notebooks)
    t0 = clock()
    vmodel = VanillaGP(train_x, train_y, RBFKernel(device=device), cfg=cfg)
    vparams = vmodel.init_params(noise=1e-2, outputscale=1.0,
                                 lengthscale=1.0 if semisup else 0.5)
    vparams, _, _ = vanilla_train(vmodel, vparams, lr=1e-1,
                                  weight_decay=0.0 if semisup else 1e-8,
                                  max_iter=max_iter or 100, tolerance=1e-2, verbose=verbose)
    vrmse, vnll = test_model(vmodel, vparams, test_x, test_y, noisy_test=True)
    vanilla_s = clock() - t0
    return {
        "config": mode,
        "device": str(device),
        "n": n,
        "num_train": int(train_x.shape[0]),
        "imgp_loss": loss,
        "imgp_rmse": rmse,
        "imgp_nll": nll,
        "vanilla_rmse": vrmse,
        "vanilla_nll": vnll,
        "hypers": {name: float(fn(params).detach()) for name, fn in (
            ("noise", model.noise), ("outputscale", model.outputscale),
            ("graphbandwidth", kernel.graphbandwidth), ("lengthscale", kernel.lengthscale))},
        "train_s": train_s,
        "loss_evaluations": len(epochs.epoch_seconds()),
        "epoch_s_median": statistics.median(epochs.epoch_seconds()),
        "vanilla_s": vanilla_s,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["supervised", "semisupervised"])
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU instead of CUDA")
    ap.add_argument("--max-iter", type=int, default=None)
    # the supervised default inits the bandwidth inside the stable basin
    # (~3.5x the median-kNN heuristic): the notebook's 1.0 collapses under
    # the learnable-bandwidth objective without a prior (PARITY.md)
    ap.add_argument("--gb-init", type=float, default=None)
    ap.add_argument("--ls-init", type=float, default=None)
    ap.add_argument("--no-gb-prior", action="store_true")
    args = ap.parse_args()
    r = run_experiment(args.mode, max_iter=args.max_iter, device="cpu" if args.cpu else "cuda",
                       gb_init=args.gb_init, ls_init=args.ls_init,
                       gb_prior=not args.no_gb_prior, verbose=args.verbose)
    print(f"RMSE Geometric: {r['imgp_rmse']:.4f}")
    print(f"NLL Geometric: {r['imgp_nll']:.4f}")
    print(f"RMSE Vanilla: {r['vanilla_rmse']:.4f}")
    print(f"NLL Vanilla: {r['vanilla_nll']:.4f}")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
