"""Port vs JAX: the campaign's whole cycle (``examples_torch/run_large.py::
run_campaign``, twin of ``tests/test_campaign.py``) at that test's size: the
1,024-point curve, k = 8, 2 epochs, the graph and basis through the keyed
caches, checkpoints and a preconditioner refresh every epoch.

The three JAX tests hold here as they are. Beside them the port's result is
held to JAX's numbers, written once by ``tests/_campaign_pins.py`` into
``examples_torch/campaign_pins.json`` (JAX's campaign is not run again
here). The port draws JAX's SLQ probes and one-hot indices: they are
replayed from the JAX trainer's key chains with JAX's own functions.
"""

import json
import pathlib

import jax
import numpy as np
import pytest

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
from examples_torch.run_large import run_campaign
from manifold_gp_tpu.ops import slq as jslq

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINS = json.loads((ROOT / "examples_torch" / "campaign_pins.json").read_text())


def _jax_randomness(kw, pins):
    """The probes of each epoch and the one-hot indices of the two
    average-variance estimates (before and after the loop) that JAX's
    ``manifold_informed_train`` draws with ``seed``."""
    n, epochs, seed = pins["num_train"], kw["epochs"], kw["seed"]
    key, probes = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        probes.append(np.asarray(jslq.rademacher_probes(sub, n, pins["num_probes"])))
    cb, idx = jax.random.PRNGKey(seed + 7919), {}
    for boundary in (0, epochs):
        cb, sub = jax.random.split(cb)
        idx[boundary] = np.asarray(jax.random.randint(sub, (100,), 0, n))
    return probes, idx


@pytest.fixture(scope="module")
def campaign_results(tmp_path_factory):
    cache_dir = str(tmp_path_factory.mktemp("campaign_cache"))
    kw, pins = PINS["campaign_kw"], PINS["pins"]
    probes, idx = _jax_randomness(kw, pins)
    shared = dict(cache_dir=cache_dir, verbose=False, device="cpu",
                  probes_fn=lambda e: probes[e], idx_fn=lambda e: idx[e], **kw)
    first, _, _ = run_campaign(**shared)
    second, _, _ = run_campaign(**shared)
    return first, second


def test_campaign_recovers_ground_truth(campaign_results):
    first, _ = campaign_results
    assert first["value"] < first["noise_floor_rmse"]
    assert np.isfinite(first["final_loss"])
    assert np.isfinite(first["nll_noisy_test"])


def test_campaign_caches_hit_on_rerun(campaign_results):
    first, second = campaign_results
    assert not first["graph_cache_hit"]
    assert not first["basis_cache_hit"]
    assert second["graph_cache_hit"]
    assert second["basis_cache_hit"]
    assert second["value"] == first["value"]
    assert first["graph_backend"] == second["graph_backend"] == "host"


def test_campaign_cg_iter_accounting(campaign_results):
    first, _ = campaign_results
    assert first["cg_iters_initial"] >= 1
    assert first["cg_iters_trained"] >= 1


def test_campaign_matches_jax(campaign_results):
    """The port's campaign against JAX's pinned run: the same graph, the
    value within 1e-3 relative, the loss trajectory and the trained
    hyperparameters at ``test_torch_train.py``'s trajectory tolerances
    (2e-3), the same CG iteration counts."""
    first, _ = campaign_results
    pins = PINS["pins"]
    assert first["num_edges"] == pins["num_edges"]
    np.testing.assert_allclose(first["graphbandwidth_floor"], pins["graphbandwidth_floor"],
                               rtol=1e-6)
    np.testing.assert_allclose(first["noise_floor_rmse"], pins["noise_floor_rmse"], rtol=1e-6)
    np.testing.assert_allclose(first["value"], pins["value"], rtol=1e-3)
    np.testing.assert_allclose(first["history"], pins["history"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(first["final_loss"], pins["final_loss"], rtol=2e-3, atol=2e-3)
    for name in ("graphbandwidth", "lengthscale", "noise", "outputscale"):
        np.testing.assert_allclose(first[f"{name}_trained"], pins[f"{name}_trained"],
                                   rtol=2e-3, err_msg=name)
    for name in ("rmse_noisy_test", "nll_noisy_test"):
        np.testing.assert_allclose(first[name], pins[name], rtol=1e-3, err_msg=name)
    assert first["cg_iters_initial"] == pins["cg_iters_initial"]
    assert first["cg_iters_trained"] == pins["cg_iters_trained"]
