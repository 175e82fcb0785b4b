#!/usr/bin/env python3
"""Reference numbers for the port's dataset and reference-protocol checks,
computed with the JAX package on the CPU.

  * ``dumbbell_pretrained``: ``examples/eval_pretrained.py``'s evaluation
    (the 1-D semisupervised dumbbell, 1,556 nodes, 10 labeled by the
    seed-1337 torch split, the reference's pretrained hyperparameters):
    IMGP RMSE and exact NLL, the NLL with LOVE rank-100 variances, the
    reference stochastic metric over probe keys 0-7 (mean and sd), the
    vanilla RBF GP's RMSE and NLL. It also records JAX's kNN indices on the
    dumbbell (``knn_idx``, [1556, 10]): the chain's 9th neighbour ties
    between the 5th node on either side, so another exact search may keep
    other edges; the port rebuilds JAX's graph from these indices. And
    ``f64_witness``: with the host f64 basis, the posterior computed in f64
    from JAX's f32 features (``examples_torch/eval_pretrained.py::f64_witness``:
    RMSE, exact NLL, the feature-space system's condition number) beside
    that model's own f32 RMSE and NLL. At noise / outputscale = 6e-5 the
    f32 metrics land ~1e-3 from the exact ones; the witness is where two
    correct implementations agree to ~1e-6.
  * ``dumbbell_bandwidth``: the bandwidth JAX trains in
    tests/test_regressions.py's two tests (every other dumbbell node, 40
    epochs; without a prior from 1.0, with the data-driven prior from 3.5 x
    the median kNN distance), beside which the port's twins report theirs.
  * ``srmnist_surrogate``: the full-size SRMNIST surrogate's fingerprint
    (shapes; sha256 of train_x, test_x and train_y as float32 bytes) and
    the scipy version that built it (``ndimage.zoom`` / ``rotate`` make the
    images), built into a temporary cache directory.

``tests/test_torch_datasets.py`` holds the port to JAX live on the CPU;
``chip_smoke.py`` phases 11 and 11b read this file on the card.

  JAX_PLATFORMS=cpu python tests/_dataset_pins.py --out examples_torch/dataset_pins.json
"""

import argparse
import json
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PRETRAINED = ROOT / "manifold_gp_tpu" / "pretrained"


def _hypers(name):
    with np.load(PRETRAINED / f"1D_{name}_semisupervised.npz") as d:
        return {k: float(d[k]) for k in d.files}


def dumbbell_knn_idx():
    """JAX's self-query kNN indices (k = 10) on the dumbbell's vertices."""
    from manifold_gp_tpu.ops.knn import knn_search
    from manifold_gp_tpu.utils import manifold_1D_dataset

    x, _, _ = manifold_1D_dataset()
    return np.asarray(knn_search(x, x, 10, self_query=True)[1])


def jax_f64_witness(knn_idx) -> dict:
    """``examples_torch/eval_pretrained.py::f64_witness`` of the JAX model at
    the pretrained values with the host f64 basis, out of sample from
    ``knn_idx`` (JAX's search of the nodes puts each node first, as
    ``features_test`` does), beside the same model's f32 metrics."""
    import jax.numpy as jnp

    from examples_torch.eval_pretrained import f64_witness

    handles = {}
    f32 = jax_pretrained_1d(eigensolver="host_f64", seeds=0, handles=handles)
    return {**f64_witness(handles, knn_idx, jnp.asarray),
            "f32": {k: f32[k] for k in ("imgp_rmse", "imgp_nll")}}


def jax_pretrained_1d(eigensolver=None, seeds: int = 8, handles=None) -> dict:
    """examples/eval_pretrained.py's numbers with the JAX package (its
    config's eigensolver replaced by ``eigensolver`` when given); ``seeds``
    = 0 skips the stochastic metric; ``handles`` (a dict) receives the model,
    its parameters, the labeled mask and the test labels."""
    import jax
    import jax.numpy as jnp
    import torch

    from manifold_gp_tpu import (
        GreaterThan,
        InferenceConfig,
        RBFKernel,
        RiemannGP,
        RiemannMaternKernel,
        VanillaGP,
    )
    from manifold_gp_tpu.utils import manifold_1D_dataset, test_model
    from manifold_gp_tpu.utils.evaluate import gaussian_nll

    jax.config.update("jax_default_matmul_precision", "highest")
    sampled_x, sampled_y, _ = manifold_1D_dataset()
    n = sampled_x.shape[0]
    torch.manual_seed(1337)
    train_idx = torch.zeros(n).scatter_(0, torch.randperm(n)[:10], 1).bool().numpy()
    train_x, train_y = sampled_x[train_idx], sampled_y[train_idx]
    test_x, test_y = sampled_x[~train_idx], sampled_y[~train_idx]
    train_y = train_y + 0.01 * torch.randn(train_y.shape[0]).numpy()
    mu_y, std_y = train_y.mean(), train_y.std(ddof=1)
    train_y = (train_y - mu_y) / std_y
    test_y = (test_y - mu_y) / std_y

    cfg = InferenceConfig(max_cholesky=2000)
    if eigensolver is not None:
        cfg = InferenceConfig(max_cholesky=2000, eigensolver=eigensolver)
    kernel = RiemannMaternKernel(
        nu=1, x=sampled_x, nearest_neighbors=10, laplacian_normalization="randomwalk",
        num_modes=50, bump_scale=10.0, bump_decay=1.0, cfg=cfg,
    )
    model = RiemannGP(train_x, train_y, kernel, labeled=train_idx,
                      noise_constraint=GreaterThan(1e-8), cfg=cfg)
    h = _hypers("manifold")
    params = model.init_params(noise=h["noise"], outputscale=h["outputscale"],
                               graphbandwidth=h["graphbandwidth"],
                               lengthscale=h["lengthscale"], mean_constant=h["mean_constant"])
    rmse, nll = test_model(model, params, test_x, test_y, noisy_test=True)
    if handles is not None:
        handles.update(model=model, params=params, labeled=train_idx, test_y=test_y)
    out = {"imgp_rmse": float(rmse), "imgp_nll": float(nll)}
    if seeds:
        samples = [test_model(model, params, test_x, test_y, noisy_test=True,
                              metric="reference", key=jax.random.PRNGKey(s))[1]
                   for s in range(seeds)]
        out["imgp_nll_reference_metric"] = {"mean": float(np.mean(samples)),
                                            "sd": float(np.std(samples, ddof=1)),
                                            "seeds": seeds}
    model.eval(params, love_rank=100)
    post = model.posterior(params, test_x, noisy_posterior=True, is_train=False)
    err = jnp.asarray(test_y, jnp.float32) - post.mean
    out["imgp_nll_love"] = float(gaussian_nll(err, post.covar))
    hv = _hypers("vanilla")
    vmodel = VanillaGP(train_x, train_y, RBFKernel(), noise_constraint=GreaterThan(1e-4),
                       cfg=cfg)
    vparams = vmodel.init_params(noise=hv["noise"], outputscale=hv["outputscale"],
                                 lengthscale=hv["lengthscale"],
                                 mean_constant=hv["mean_constant"])
    vrmse, vnll = test_model(vmodel, vparams, test_x, test_y, noisy_test=True)
    out.update(vanilla_rmse=float(vrmse), vanilla_nll=float(vnll))
    return out


def dumbbell_half():
    """tests/test_regressions.py's data: every other dumbbell node."""
    from manifold_gp_tpu.utils import manifold_1D_dataset

    x, y, _ = manifold_1D_dataset()
    sub = np.arange(0, x.shape[0], 2)
    x, y = x[sub], y[sub]
    rng = np.random.default_rng(1337)
    y = y + 0.01 * rng.standard_normal(y.shape[0]).astype(np.float32)
    return x, (y - y.mean()) / y.std()


def jax_dumbbell_bandwidths() -> dict:
    """The bandwidths JAX trains in the two tests (their own helpers)."""
    from manifold_gp_tpu.priors import GammaPrior
    from test_regressions import _median_knn_distance, _train_1d

    x, y = dumbbell_half()
    median, gb_min = _median_knn_distance(x)
    rate = 4.0 * median / (median - gb_min) ** 2
    return {"median_knn": median,
            "no_prior": _train_1d(x, y, gb_prior=None, gb_init=1.0),
            "prior": _train_1d(x, y, gb_prior=GammaPrior(rate * median + 1.0, rate),
                               gb_init=3.5 * median)}


def srmnist_fingerprint(cache_dir) -> dict:
    """The JAX package's full-size SRMNIST surrogate, built into
    ``cache_dir``, fingerprinted as the port's ``run_rmnist`` does."""
    import scipy

    from examples_torch.run_rmnist import dataset_fingerprint
    from manifold_gp_tpu.utils import rmnist_dataset

    tx, ty, _, ex, _, _ = rmnist_dataset(single_digit=True, cache_dir=cache_dir)
    return {**dataset_fingerprint(tx, ex, ty), "scipy": scipy.__version__}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "examples_torch" / "dataset_pins.json")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    pins = jax_pretrained_1d()
    knn_idx = dumbbell_knn_idx()
    witness = jax_f64_witness(knn_idx)
    pins["f64_witness"] = {k: v for k, v in witness.items() if k != "z"}
    pins["knn_idx"] = knn_idx.tolist()
    with tempfile.TemporaryDirectory() as tmp:
        fingerprint = srmnist_fingerprint(tmp)
    out = {
        "_comment": "JAX package on the CPU (tests/_dataset_pins.py): the 1-D pretrained "
                    "evaluation of examples/eval_pretrained.py with JAX's dumbbell kNN "
                    "indices and its f64 witness (host f64 basis); the bandwidths of "
                    "tests/test_regressions.py's two dumbbell tests; and the full-size "
                    "SRMNIST surrogate's fingerprint.",
        "dumbbell_pretrained": pins,
        "dumbbell_bandwidth": jax_dumbbell_bandwidths(),
        "srmnist_surrogate": fingerprint,
    }
    args.out.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(json.dumps({k: v for k, v in pins.items() if k != "knn_idx"}, indent=1))
    print(json.dumps(out["dumbbell_bandwidth"], indent=1))
    print(json.dumps(fingerprint, indent=1))


if __name__ == "__main__":
    main()
