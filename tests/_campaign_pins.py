#!/usr/bin/env python3
"""Reference numbers for the port's campaign twin, computed with the JAX
package on the CPU.

Runs ``examples/run_large.py::run_campaign`` at ``tests/test_campaign.py``'s
size (1,024 points on the curve, k = 8, 2 epochs, 64 held out, 16 modes,
checkpoints and preconditioner refresh every epoch) and writes its result
unrounded: the campaign rounds its result dict with the builtin ``round``,
which this script shadows in the campaign's module with the identity, and
the per-epoch losses come from its JSONL metrics.

The port's twin (``tests/test_torch_campaign.py``) draws the same SLQ probes
and one-hot indices by replaying the JAX trainer's key chains with JAX's own
functions, so the pins hold no random arrays.

  JAX_PLATFORMS=cpu python tests/_campaign_pins.py --out examples_torch/campaign_pins.json
"""

import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

# tests/test_campaign.py's run
CAMPAIGN_KW = dict(n=1024, k=8, epochs=2, num_test=64, num_modes=16, checkpoint_every=1,
                   precond_refresh=1, seed=0, manifold="curve")


def campaign_pins() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import run_large

    run_large.round = lambda value, ndigits=None: value  # keep every number unrounded
    with tempfile.TemporaryDirectory() as tmp:
        metrics = pathlib.Path(tmp) / "metrics.jsonl"
        result, params, model = run_large.run_campaign(
            cache_dir=tmp, metrics_path=str(metrics), **CAMPAIGN_KW)
        rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    keep = ("value", "final_loss", "graphbandwidth_trained", "graphbandwidth_floor",
            "lengthscale_trained", "noise_trained", "rmse_noisy_test", "nll_noisy_test",
            "noise_floor_rmse", "cg_iters_initial", "cg_iters_trained")
    pins = {key: result[key] for key in keep}
    pins["outputscale_trained"] = float(model.outputscale(params))
    pins["num_edges"] = int(model.kernel.graph.num_edges)
    pins["num_train"] = int(model.kernel.graph.num_nodes)
    pins["num_probes"] = int(model.cfg.num_probes)
    pins["history"] = [row["loss"] for row in rows]
    return {"campaign_kw": CAMPAIGN_KW, "pins": pins}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "examples_torch" / "campaign_pins.json"))
    args = ap.parse_args()
    out = campaign_pins()
    print(json.dumps(out, indent=1), file=sys.stderr)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
