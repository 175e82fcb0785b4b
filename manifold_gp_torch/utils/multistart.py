"""Multi-start hyperparameter training (port of
``manifold_gp_tpu.utils.multistart``).

The precision-form marginal likelihood is multi-modal in the (bandwidth,
lengthscale) plane; ``multi_start_train`` trains R inits and keeps the best.
The JAX package vmaps the whole epoch scan over the restarts; the port
loops over them, each with its own Adam state, plateau scheduler and probe
generator (the hand-written kernels have no restart axis).

Restrictions, as in the JAX package: no outputscale re-normalization, no
early stop (max_iter + 1 steps), and the losses returned are each restart's
last evaluated loss.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .train import ReduceLROnPlateau, _train_loop


def random_restarts(
    model,
    generator,
    num_restarts: int,
    noise=1e-2,
    outputscale=1.0,
    graphbandwidth_range=(1e-2, 1.0),
    lengthscale_range=(0.3, 10.0),
) -> list:
    """Log-uniform random inits over the (bandwidth, lengthscale) plane.
    ``generator``: a CPU ``torch.Generator`` or an int seed for one."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))

    def log_uniform(lo, hi):
        u = float(torch.rand((), generator=generator, dtype=torch.float64))
        return math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))

    inits = []
    for _ in range(num_restarts):
        gb = log_uniform(*graphbandwidth_range)
        ls = log_uniform(*lengthscale_range)
        inits.append(model.init_params(noise=noise, outputscale=outputscale,
                                       graphbandwidth=gb, lengthscale=ls))
    return inits


def multi_start_train(
    model,
    inits: list,
    lr: float = 1e-1,
    weight_decay: float = 0.0,
    max_iter: int = 100,
    scheduler: Optional[ReduceLROnPlateau] = None,
    seed: int = 0,
    return_all: bool = False,
):
    """Train every init in ``inits`` for max_iter + 1 Adam steps, one after
    another, and return the best.

    Restart r draws its SLQ probes from a generator seeded with seed + r
    (restart 0 therefore draws what ``manifold_informed_train(seed=seed)``
    draws). The inits are not modified.

    Returns (best_params, best_loss, losses[R]), or with ``return_all=True``
    (stacked_params {name: [R, ...]}, losses[R]); ``losses`` is a float64
    CPU tensor."""
    device = model.device
    finals, losses = [], []
    for r, init in enumerate(inits):
        params = {k: v.detach().clone() for k, v in init.items()}
        generator = torch.Generator(device=device).manual_seed(seed + r)

        def loss_fn(p, epoch, aux, generator=generator):
            return model.mll_loss(p, generator=generator)

        # tolerance -inf: the loop's early stop never fires (max_iter + 1 steps)
        params, loss, _ = _train_loop(model, params, loss_fn, lr, weight_decay, max_iter,
                                      -math.inf, scheduler, False, generator)
        finals.append({k: v.detach() for k, v in params.items()})
        losses.append(loss)
    losses = torch.tensor(losses, dtype=torch.float64)
    if return_all:
        return {k: torch.stack([p[k] for p in finals]) for k in finals[0]}, losses
    best = int(torch.argmin(losses))
    return finals[best], float(losses[best]), losses
