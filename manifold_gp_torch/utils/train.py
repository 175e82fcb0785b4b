"""Training loop: precision-form manifold training (port of
``manifold_gp_tpu.utils.train``).

``manifold_informed_train``: pre-loop outputscale normalization by the
average precision-inverse variance, Adam on the precision-form negative MLL,
optional periodic re-normalization every ``update_norm`` epochs, plateau LR
scheduling, |delta loss| <= tolerance early stop, and the post-loop
outputscale de-normalization.

Epochs are a Python loop: one loss-and-gradient, one ``torch.optim.Adam``
step and one scheduler step each. The parameter tensors keep their identity
through the run (the optimizer holds them): the re-normalization writes the
new raw outputscale in place.

``vanilla_train``: the same loop on a vanilla GP's exact marginal
likelihood, with no outputscale normalization.

On a mesh model (``RiemannGP`` over a mesh kernel) the loop runs as it is
on every rank: the loss and its gradients are replicated, so the Adam steps
keep the parameters identical on every rank, and rank 0 alone writes the
checkpoints.

Randomness: the SLQ probes of epoch e come from ``probes_fn(e)`` when given,
else from a ``torch.Generator`` seeded with ``seed``; the one-hot indices of
an average-variance estimate from ``idx_fn(epoch)``, else from a second
generator seeded with ``seed + 7919``. Both generators' states are
checkpointed, so a resumed run replays the uninterrupted one.

Spans (``utils.metrics``): ``imgp.train.run`` (a whole training),
``imgp.train.epoch``, ``imgp.train.normalize`` (each average-variance
estimate: its one-hot CG solve ends in a stop-test read, so its host
seconds are the device's), ``imgp.train.precond_build``,
``imgp.train.backward`` (this thread waits while the autograd engine runs
the backward on its own thread for CUDA tensors) and ``imgp.train.step``
(the optimizer step and the epoch's host reads of the loss and parameters,
counted as ``host_sync.train.loss`` and ``host_sync.train.params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .metrics import count, span, spanned


@dataclasses.dataclass(frozen=True)
class ReduceLROnPlateau:
    """Plateau scheduler config with torch semantics (mode='min',
    threshold_mode='rel'); the state is (best, num_bad, cooldown_counter)."""

    factor: float = 0.5
    patience: int = 200
    threshold: float = 1e-3
    cooldown: int = 0
    min_lr: float = 0.0

    def init_state(self):
        return (math.inf, 0, 0)


def _sched_update(cfg: ReduceLROnPlateau, loss: float, lr: float, state):
    """One torch-exact ReduceLROnPlateau step."""
    best, num_bad, cooldown_counter = state
    if loss < best * (1.0 - cfg.threshold):
        best, num_bad = loss, 0
    else:
        num_bad += 1
    if cooldown_counter > 0:
        cooldown_counter -= 1
        num_bad = 0
    if num_bad > cfg.patience:
        lr = max(lr * cfg.factor, cfg.min_lr)
        cooldown_counter = cfg.cooldown
        num_bad = 0
    return lr, (best, num_bad, cooldown_counter)


_TRACKED = (
    ("noise", "raw_noise", lambda m, p: m.noise(p)),
    ("outputscale", "raw_outputscale", lambda m, p: m.outputscale(p)),
    ("lengthscale", "raw_lengthscale", lambda m, p: m.kernel.lengthscale(p)),
    ("graphbandwidth", "raw_graphbandwidth", lambda m, p: m.kernel.graphbandwidth(p)),
)
_LABELS = {
    "noise": "Noise Variance",
    "outputscale": "Signal Variance",
    "lengthscale": "Lengthscale",
    "graphbandwidth": "Graphbandwidth",
}


def _adam_state(opt, params):
    return {name: dict(opt.state[p]) for name, p in params.items() if p in opt.state}


def _train_loop(
    model,
    params,
    loss_fn,
    lr,
    weight_decay,
    max_iter,
    tolerance,
    scheduler,
    verbose,
    generator,
    on_epoch_end=None,
    callback_period: Optional[int] = None,
    metrics=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    callback_generator=None,
    debug: bool = False,
    aux_fn=None,
    aux_period: Optional[int] = None,
):
    """The training loop over epochs 0..max_iter.

    ``loss_fn(params, epoch, aux)`` returns the scalar loss.
    ``on_epoch_end(epoch, params)`` fires after epochs where
    ``epoch % callback_period == 0`` (with a post-increment epoch counter)
    and updates ``params`` in place. ``aux_fn(params) -> aux`` is rebuilt
    every ``aux_period`` epochs (preconditioners cached across epochs: they
    are detached estimator state, so staleness affects iteration counts,
    never gradients).
    """
    names = list(params)
    for p in params.values():
        p.requires_grad_(True)
    # torch.optim.Adam: L2 decay added to the gradient *before* the Adam
    # moments, then the lr scaling. A parameter the loss does not reach gets
    # a zero gradient, not none, so that the decay still applies to it.
    opt = torch.optim.Adam([params[k] for k in names], lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    sched_state = scheduler.init_state() if scheduler is not None else (math.inf, 0, 0)
    tracked = [(n, fn) for n, raw, fn in _TRACKED if raw in params]

    total = max_iter + 1  # the loop runs while epoch <= max_iter
    period = callback_period if (on_epoch_end and callback_period) else total
    cur_lr = float(lr)
    history: list = []
    epoch = 0
    if checkpoint_path and resume:
        from .checkpoint import load_training_state

        ckpt = load_training_state(checkpoint_path, device=model.device)
        if ckpt is not None and ckpt["epoch"] < total:
            with torch.no_grad():
                for k in names:
                    params[k].copy_(ckpt["params"][k])
            for k, st in ckpt["opt_state"].items():
                opt.state[params[k]] = st
            epoch, cur_lr, sched_state = ckpt["epoch"], ckpt["lr"], ckpt["sched_state"]
            if generator is not None and ckpt["generator_state"] is not None:
                generator.set_state(ckpt["generator_state"])
            if callback_generator is not None and ckpt["callback_generator_state"] is not None:
                callback_generator.set_state(ckpt["callback_generator_state"])
            if verbose:
                print(f"[resume] epoch {epoch} from {checkpoint_path}")
    next_ckpt = (
        (epoch // checkpoint_every + 1) * checkpoint_every
        if (checkpoint_path and checkpoint_every)
        else None
    )
    aux = None
    aux_next = epoch  # rebuild immediately on entry (incl. after a resume)
    while epoch < total:
        with span("imgp.train.epoch"):
            if aux_fn is not None and epoch >= aux_next:
                with span("imgp.train.precond_build"):
                    aux = aux_fn(params)
                # next rebuild at the next ABSOLUTE multiple of aux_period, so a
                # resumed run re-joins the uninterrupted run's refresh epochs
                period_abs = aux_period or total
                aux_next = (epoch // period_abs + 1) * period_abs
            for group in opt.param_groups:
                group["lr"] = cur_lr
            loss = loss_fn(params, epoch, aux)
            with span("imgp.train.backward"):
                grads = torch.autograd.grad(loss, [params[k] for k in names],
                                            allow_unused=True)
                for k, g in zip(names, grads):
                    params[k].grad = torch.zeros_like(params[k]) if g is None else g
            with span("imgp.train.step"):
                opt.step()
                count("host_sync.train.loss")
                out = {"loss": float(loss.detach()), "lr": cur_lr}
                with torch.no_grad():
                    for name, fn in tracked:
                        count("host_sync.train.params")
                        out[name] = float(fn(model, params).reshape(()))
            if scheduler is not None:
                cur_lr, sched_state = _sched_update(scheduler, out["loss"], cur_lr, sched_state)
            if debug:
                # NaN guard: fail fast with the epoch instead of training on
                # poisoned parameters for the rest of the run
                from .debug import check_finite

                if not math.isfinite(out["loss"]):
                    raise FloatingPointError(
                        f"non-finite training loss {out['loss']} at epoch {epoch}")
                check_finite(params, name=f"params after epoch {epoch}")
            history.append(out["loss"])
            if metrics is not None:
                metrics.record(epoch, **out)
            if verbose:
                msg = [f"Iteration: {epoch}, Loss: {out['loss']:0.3f}, Lr: {out['lr']:g}"]
                msg += [f"{_LABELS[name]}: {out[name]:0.3f}" for name, _ in tracked]
                print(",\t".join(msg))
            epoch += 1
            # Parity quirk: the early stop compares against a 1e6 sentinel that
            # is never updated, so it effectively never fires and training runs
            # all max_iter+1 epochs. Preserved as it is.
            if abs(out["loss"] - 1e6) <= tolerance:
                break
            if on_epoch_end is not None and epoch < total and epoch % period == 0:
                on_epoch_end(epoch, params)
            # Checkpoint AFTER the epoch-boundary callback so the saved params
            # (and callback generator) already include its effect.
            if next_ckpt is not None and epoch >= next_ckpt:
                from .checkpoint import save_training_state
                from .metrics import is_host_zero

                # on a mesh every rank holds the same state: rank 0 writes it
                if is_host_zero():
                    save_training_state(
                        checkpoint_path, params, _adam_state(opt, params), epoch, cur_lr,
                        sched_state,
                        generator_state=None if generator is None else generator.get_state(),
                        callback_generator_state=(
                            None if callback_generator is None else callback_generator.get_state()
                        ),
                    )
                next_ckpt = (epoch // checkpoint_every + 1) * checkpoint_every
    return params, history[-1] if history else float("nan"), history


@spanned("imgp.train.run")
def manifold_informed_train(
    model,
    params,
    lr: float = 1e-1,
    weight_decay: float = 0.0,
    max_iter: int = 100,
    tolerance: float = 1e-2,
    update_norm: Optional[int] = None,
    num_rand_vec: int = 100,
    scheduler: Optional[ReduceLROnPlateau] = None,
    verbose: bool = False,
    seed: int = 0,
    metrics=None,
    checkpoint_path=None,
    checkpoint_every=None,
    resume: bool = True,
    debug: bool = False,
    precond_refresh: Optional[int] = None,
    probes_fn: Optional[Callable] = None,
    idx_fn: Optional[Callable] = None,
):
    """IMGP hyperparameter training. Returns (params, final_loss, history);
    ``params`` is updated in place.

    ``metrics``: any object with ``.record(epoch, **values)``.
    ``checkpoint_path`` + ``checkpoint_every`` enable resumable training
    (full optimizer/scheduler/generator state every k epochs).
    ``precond_refresh``: rebuild the config-selected preconditioner every
    this many epochs and reuse it in between, instead of inside every loss
    evaluation.
    ``probes_fn(epoch)`` / ``idx_fn(epoch)``: the SLQ probes of an epoch and
    the one-hot indices of the average-variance estimate made at an epoch
    boundary (0 before the loop, the boundary's epoch for a
    re-normalization, max_iter + 1 after the loop), for runs that share
    their randomness with another implementation.
    """
    device = model.device
    generator = None if probes_fn is not None else torch.Generator(device=device).manual_seed(seed)
    cb_generator = (
        None if idx_fn is not None else torch.Generator(device=device).manual_seed(seed + 7919)
    )

    @spanned("imgp.train.normalize")
    @torch.no_grad()
    def avg_var(p, epoch):
        idx = None if idx_fn is None else idx_fn(epoch)
        return model.average_variance(p, num_rand_vec=num_rand_vec, generator=cb_generator,
                                      idx=idx)

    @torch.no_grad()
    def set_outputscale(p, value):
        # in place: the optimizer holds this tensor
        p["raw_outputscale"].copy_(model.set_outputscale(p, value)["raw_outputscale"])

    if model.use_outputscale:
        set_outputscale(params, model.outputscale(params) / avg_var(params, 0))

    def on_epoch_end(epoch, p):
        # Reached only at epoch % (update_norm + 1) == 0 boundaries.
        if verbose:
            print("Update covariance normalization at epoch: ", epoch)
        set_outputscale(p, 1.0 / avg_var(p, epoch))

    def loss_fn(p, epoch, aux):
        probes = None if probes_fn is None else _as_probes(probes_fn(epoch), device)
        return model.mll_loss(p, generator=generator, precond_override=aux, probes=probes)

    params, loss_val, history = _train_loop(
        model,
        params,
        loss_fn,
        lr,
        weight_decay,
        max_iter,
        tolerance,
        scheduler,
        verbose,
        generator,
        on_epoch_end=on_epoch_end if update_norm is not None else None,
        callback_period=(update_norm + 1) if update_norm is not None else None,
        metrics=metrics,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        resume=resume,
        callback_generator=cb_generator,
        debug=debug,
        aux_fn=model.build_precond if precond_refresh is not None else None,
        aux_period=precond_refresh,
    )

    if model.use_outputscale:
        set_outputscale(params, model.outputscale(params) * avg_var(params, max_iter + 1))
    return params, loss_val, history


def _as_probes(probes, device):
    """``probes_fn``'s return value (a tensor, an array, or a pair of
    either for the mBCG log-det) as f32 tensors on ``device``."""
    if probes is None:
        return None
    if isinstance(probes, tuple):
        return tuple(_as_probes(p, device) for p in probes)
    if not isinstance(probes, torch.Tensor):
        probes = torch.tensor(np.asarray(probes, np.float32))
    return probes.to(device=device, dtype=torch.float32)


@spanned("imgp.train.run")
def vanilla_train(
    model,
    params,
    lr: float = 1e-1,
    weight_decay: float = 0.0,
    max_iter: int = 100,
    tolerance: float = 1e-2,
    scheduler: Optional[ReduceLROnPlateau] = None,
    verbose: bool = False,
    seed: int = 0,
    metrics=None,
    checkpoint_path=None,
    checkpoint_every=None,
    resume: bool = True,
    debug: bool = False,
    probes_fn: Optional[Callable] = None,
):
    """Exact-MLL training of a ``models.VanillaGP`` (Adam, plateau
    scheduler, the same loop as ``manifold_informed_train``). Returns
    (params, final_loss, history); ``params`` is updated in place. Above
    ``cfg.max_cholesky`` the BBMM loss draws its probes from a generator
    seeded with ``seed``, or takes epoch e's pair (zm, zr) from
    ``probes_fn(e)``."""
    device = model.device
    generator = None if probes_fn is not None else torch.Generator(device=device).manual_seed(seed)

    def loss_fn(p, epoch, aux):
        probes = None if probes_fn is None else _as_probes(probes_fn(epoch), device)
        return model.mll_loss(p, generator=generator, probes=probes)

    return _train_loop(
        model, params, loss_fn, lr, weight_decay, max_iter, tolerance, scheduler, verbose,
        generator, metrics=metrics, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume, debug=debug,
    )
