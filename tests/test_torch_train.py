"""Port vs JAX: the training slice as a whole — ``mll_loss`` value and
gradients, ``average_variance``, a 5-epoch ``manifold_informed_train``
trajectory, and checkpoint / resume.

The same numpy inputs go through both packages on the CPU. Randomness is
shared: the JAX side's probes and one-hot indices are handed to the port
(for a single loss by patching the name the JAX engine draws through; for a
trajectory by replaying JAX's own key chain with JAX's own functions).
Gradient parity runs at a tight CG tolerance: at the campaign's 1e-2 the
solution depends on the iteration at which each column freezes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_data import one_torch_thread  # noqa: F401  (autouse, module scope)
import manifold_gp_tpu as J
import manifold_gp_torch as T
from examples_torch.run_large import torus_points
from manifold_gp_tpu.ops import block_sparse as jbs
from manifold_gp_tpu.ops import engine as jengine
from manifold_gp_tpu.ops import pallas_spmv as jps
from manifold_gp_tpu.ops import slq as jslq
from manifold_gp_tpu.priors import GammaPrior as JGammaPrior
from manifold_gp_tpu.priors import data_driven_bandwidth_prior as j_bandwidth_prior
from manifold_gp_tpu.utils import train as jtrain
from manifold_gp_torch import priors as tpriors
from manifold_gp_torch.ops.pivchol import LowRankDiagPrecond
from manifold_gp_torch.utils import (
    ReduceLROnPlateau,
    constrained_values,
    load_params,
    load_training_state,
    manifold_informed_train,
    params_from_constrained,
    params_from_jax,
    params_to_numpy,
    save_params,
    vanilla_train,
)

RAW = ("raw_graphbandwidth", "raw_lengthscale", "raw_noise", "raw_outputscale")
INIT = dict(noise=1e-2, outputscale=1.0, graphbandwidth=0.15, lengthscale=1.0)


def _models(n, seed=3, prior=False, **cfg_kw):
    """The same torus regression problem as a JAX and a port model, on the
    block-ELL path (dense_operator_max_size=0, use_dia=False)."""
    x, u, _ = torus_points(n, seed=seed)
    rng = np.random.default_rng(seed)
    y = (np.sin(2 * u) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(dense_operator_max_size=0, use_dia=False, num_probes=8, lanczos_max_iter=12,
              cg_tolerance=1e-6, cg_max_iter=400)
    kw.update(cfg_kw)
    jc, tc = J.InferenceConfig(**kw), T.InferenceConfig(**kw)
    common = dict(nu=2, x=x, nearest_neighbors=10, laplacian_normalization="randomwalk")
    jp = tp = None
    if prior:
        jp, tp = JGammaPrior(3.0, 8.0), tpriors.GammaPrior(3.0, 8.0)
    jk = J.RiemannMaternKernel(cfg=jc, graphbandwidth_prior=jp,
                               graphbandwidth_constraint=J.GreaterThan(0.02), **common)
    tk = T.RiemannMaternKernel(cfg=tc, graphbandwidth_prior=tp, device="cpu",
                               graphbandwidth_constraint=T.GreaterThan(0.02), **common)
    assert tk.block_layout is not None and tk.block_layout.max_blocks == jk.block_layout.max_blocks
    return J.RiemannGP(x, jnp.asarray(y), jk, cfg=jc), T.RiemannGP(x, y, tk, cfg=tc)


def _rademacher(n, p, seed=0):
    return (2 * np.random.default_rng(seed).integers(0, 2, (n, p)) - 1).astype(np.float32)


def _loss_and_grads(jm, tm, probes, monkeypatch, init=INIT):
    if probes is not None:
        monkeypatch.setattr(jengine, "rademacher_probes",
                            lambda key, n_, p_: jnp.asarray(probes))
    jl, jg = jax.value_and_grad(lambda p: jm.mll_loss(p, key=jax.random.PRNGKey(0)))(
        jm.init_params(**init))
    tp = {k: v.requires_grad_(True) for k, v in tm.init_params(**init).items()}
    tl = tm.mll_loss(tp, probes=None if probes is None else torch.from_numpy(probes))
    tg = torch.autograd.grad(tl, [tp[k] for k in RAW])
    (unused,) = torch.autograd.grad(tm.mll_loss(tp, probes=None if probes is None
                                                else torch.from_numpy(probes)),
                                    [tp["mean_constant"]], allow_unused=True)
    assert unused is None and float(jg["mean_constant"]) == 0.0  # neither moves it
    return float(jl), np.array([float(jg[k]) for k in RAW]), float(tl.detach()), np.array(
        [float(g) for g in tg])


def _jax_panel_vjp(jm, monkeypatch):
    """Take the JAX model's panel-space cotangents through its own custom VJP
    (``make_matvec_ad``), as on a TPU: at this size its backward takes the
    bf16 einsum branch, which rounds both factors to bf16 as K3 does (the CPU
    default differentiates the plain einsum, with g unrounded). Its forward
    kernel needs a TPU, so it runs as the plain einsum, the same product."""
    monkeypatch.setattr(jps, "_run_block_kernel",
                        lambda layout, blocks, pv, interpret=False:
                        jbs.matvec_permuted(layout, blocks, pv))
    monkeypatch.setattr(jm.kernel, "use_pallas", True)


@pytest.mark.parametrize("mode,dtype,n", [("edge", "float32", 1500), ("panel", "float32", 5000),
                                          ("edge", "bfloat16", 1500), ("panel", "bfloat16", 1500)])
def test_mll_loss_slq_branch_matches_jax(mode, dtype, n, monkeypatch):
    """The block path's SLQ branch with shared probes, with edge- and with
    panel-space cotangents over f32 panels; and over bf16 panels, the
    campaign's edge cotangents and the panel cotangents that round K3's
    factors and result to bf16, at a size where the CPU's emulated bf16
    products stay cheap. dense_operator_max_size=0 keeps every size on the
    block path. At N = 1,500 JAX's edge and panel gradients over bf16
    panels differ by 2.8e-4 of the largest, inside the gradient tolerance,
    so this case holds the panel path end to end but cannot tell the two
    roundings apart: test_torch_bwd_blocks pins the rounding at the VJP,
    and the 16k pins (a 1.67e-2 gap) on the card."""
    jm, tm = _models(n, max_cholesky=0, solve_cotangent=mode, spmv_dtype=dtype, prior=True)
    if (mode, dtype) == ("panel", "bfloat16"):
        _jax_panel_vjp(jm, monkeypatch)
    probes = _rademacher(n, 8)
    jl, jg, tl, tg = _loss_and_grads(jm, tm, probes, monkeypatch)
    # loss: a matvec and 12 Lanczos steps, f32 sum order apart
    np.testing.assert_allclose(tl, jl, rtol=5e-5)
    # gradients: CG solves stopped at 1e-6 on both sides
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())


@pytest.mark.parametrize("mode", ["edge", "panel"])
def test_mll_loss_exact_branch_matches_jax(mode, monkeypatch):
    """n <= max_cholesky: densify through the block matvec, Cholesky; no
    probes and no solves, so gradients are held tightly."""
    jm, tm = _models(500, max_cholesky=800, solve_cotangent=mode)
    jl, jg, tl, tg = _loss_and_grads(jm, tm, None, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    np.testing.assert_allclose(tg, jg, rtol=5e-4, atol=5e-4 * np.abs(jg).max())


def test_mll_loss_draws_from_a_generator_and_rejects_unported_options():
    _, tm = _models(300, max_cholesky=0)
    p = tm.init_params(**INIT)
    with pytest.raises(ValueError, match="Generator"):
        tm.mll_loss(p)
    a = tm.mll_loss(p, generator=torch.Generator().manual_seed(4))
    b = tm.mll_loss(p, generator=torch.Generator().manual_seed(4))
    assert float(a) == float(b) and np.isfinite(float(a))
    _, piv = _models(300, max_cholesky=0, precond_type="pivchol")
    assert np.isfinite(float(piv.mll_loss(p, generator=torch.Generator().manual_seed(4))))
    assert isinstance(piv.build_precond(p), LowRankDiagPrecond)
    _, mbcg = _models(300, max_cholesky=0, slq_precond_quadrature=True)
    assert np.isfinite(float(mbcg.mll_loss(p, generator=torch.Generator().manual_seed(4))))
    _, none = _models(300, max_cholesky=0, precond_type="none")
    assert none.precision_precond(p) is None and none.build_precond(p) is None
    # vanilla_train is ported: a few epochs of a vanilla GP on the same data
    vm = T.VanillaGP(tm.train_x, tm.train_y, T.RBFKernel(device="cpu"))
    _, vloss, vhist = vanilla_train(vm, vm.init_params(noise=1e-2, lengthscale=0.5), max_iter=3)
    assert len(vhist) == 4 and np.isfinite(vloss) and vhist[-1] < vhist[0]


def test_average_variance_matches_jax_with_shared_indices(monkeypatch):
    jm, tm = _models(500, max_cholesky=0)
    idx = np.random.default_rng(5).integers(0, 500, 20)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(idx))
    jav = jm.average_variance(jm.init_params(**INIT), num_rand_vec=20, key=jax.random.PRNGKey(0))
    tav = tm.average_variance(tm.init_params(**INIT), num_rand_vec=20, idx=torch.from_numpy(idx))
    np.testing.assert_allclose(float(tav), float(jav), rtol=1e-4)
    # every node (num_rand_vec >= N) needs no indices
    jall = jm.average_variance(jm.init_params(**INIT), num_rand_vec=500)
    tall = tm.average_variance(tm.init_params(**INIT), num_rand_vec=500)
    np.testing.assert_allclose(float(tall), float(jall), rtol=1e-4)


def test_priors_match_jax():
    v = np.array([0.3, 1.7], np.float32)
    for name, args in (("GammaPrior", (2.5, 3.0)), ("InverseGammaPrior", (3.0, 0.7)),
                       ("NormalPrior", (0.4, 1.3))):
        want = getattr(J.priors, name)(*args).log_prob(jnp.asarray(v))
        got = getattr(tpriors, name)(*args).log_prob(torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    d = np.sort(np.random.default_rng(2).uniform(0.01, 1.0, (300, 6)).astype(np.float32), axis=1)
    jmin, jprior = j_bandwidth_prior(jnp.asarray(d))
    tmin, tprior = tpriors.data_driven_bandwidth_prior(torch.from_numpy(d))
    np.testing.assert_allclose(tmin, jmin, rtol=1e-6)
    np.testing.assert_allclose([tprior.concentration, tprior.rate],
                               [jprior.concentration, jprior.rate], rtol=1e-5)


class _Recorder:
    def __init__(self):
        self.rows = []

    def record(self, epoch, **values):
        self.rows.append({"epoch": epoch, **values})


def test_training_trajectory_matches_jax():
    """5 epochs of manifold_informed_train, SLQ branch on the block path
    with edge cotangents; the outputscale re-normalization fires once (after
    epoch 3) and the plateau scheduler halves the learning rate once."""
    n, seed, num_rand_vec, epochs = 600, 0, 20, 5
    jm, tm = _models(n, max_cholesky=0, solve_cotangent="edge", prior=True)
    # the loss falls by 60-97 % an epoch here: asking for 90 % makes epoch 1 a
    # bad one, patience 0 trips on it, and the cooldown outlasts the run
    sched = dict(factor=0.5, patience=0, threshold=0.9, cooldown=10)
    kw = dict(lr=0.1, weight_decay=1e-3, max_iter=epochs - 1, update_norm=2,
              num_rand_vec=num_rand_vec, seed=seed)

    # JAX's own key chains, replayed with JAX's own functions
    key = jax.random.PRNGKey(seed)
    probes = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        probes.append(np.asarray(jslq.rademacher_probes(sub, n, jm.cfg.num_probes)))
    cb = jax.random.PRNGKey(seed + 7919)
    idx = {}
    for boundary in (0, 3, epochs):  # before the loop, the re-normalization, after it
        cb, sub = jax.random.split(cb)
        idx[boundary] = np.asarray(jax.random.randint(sub, (num_rand_vec,), 0, n))

    jrec, trec = _Recorder(), _Recorder()
    jp, jloss, jhist = jtrain.manifold_informed_train(
        jm, jm.init_params(**INIT), scheduler=jtrain.ReduceLROnPlateau(**sched),
        metrics=jrec, chunk_size=1, **kw)
    tp0 = params_from_jax({k: np.asarray(v) for k, v in jm.init_params(**INIT).items()}, "cpu")
    tp, tloss, thist = manifold_informed_train(
        tm, tp0, scheduler=ReduceLROnPlateau(**sched), metrics=trec,
        probes_fn=lambda e: probes[e], idx_fn=lambda e: idx[e], **kw)

    assert tp is tp0  # updated in place: the optimizer holds these tensors
    assert len(thist) == len(jhist) == epochs
    assert [r["lr"] for r in trec.rows] == pytest.approx([r["lr"] for r in jrec.rows])
    assert sorted({r["lr"] for r in trec.rows}) == pytest.approx([0.05, 0.1])  # one trip
    # Adam divides by sqrt(v): early steps are nearly sign steps, so the
    # trajectories stay within the gradients' own agreement (~1e-3)
    np.testing.assert_allclose(thist, jhist, rtol=2e-3, atol=2e-3)
    for name in ("noise", "outputscale", "lengthscale", "graphbandwidth"):
        np.testing.assert_allclose([r[name] for r in trec.rows], [r[name] for r in jrec.rows],
                                   rtol=2e-3, err_msg=name)
    # the re-normalization after epoch 3 rewrote the outputscale (a jump no
    # Adam step of lr 0.05 makes), identically on both sides
    jumps = np.abs(np.diff(np.log([r["outputscale"] for r in trec.rows])))
    assert int(np.argmax(jumps)) == 2
    got, want = params_to_numpy(tp), {k: np.asarray(v) for k, v in jp.items()}
    for k in RAW:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-3, err_msg=k)
    assert float(got["mean_constant"]) == float(want["mean_constant"]) == 0.0
    np.testing.assert_allclose(tloss, jloss, rtol=2e-3, atol=2e-3)


def test_checkpoint_resume_reproduces_the_uninterrupted_run(tmp_path):
    _, tm = _models(400, max_cholesky=0, solve_cotangent="edge", cg_tolerance=1e-4)
    kw = dict(lr=0.1, max_iter=5, update_norm=2, num_rand_vec=10, seed=7,
              scheduler=ReduceLROnPlateau(patience=1, threshold=0.2))
    full = _Recorder()
    p_full, loss_full, hist_full = manifold_informed_train(
        tm, tm.init_params(**INIT), metrics=full, **kw)

    class Interrupt(Exception):
        pass

    class StopAt(_Recorder):
        def record(self, epoch, **values):
            if epoch == 4:
                raise Interrupt
            super().record(epoch, **values)

    ckpt = tmp_path / "run.ckpt.npz"
    with pytest.raises(Interrupt):
        manifold_informed_train(tm, tm.init_params(**INIT), metrics=StopAt(),
                                checkpoint_path=ckpt, checkpoint_every=2, **kw)
    state = load_training_state(ckpt, device="cpu")
    assert state["epoch"] == 4 and set(state["opt_state"]) == set(tm.init_params())
    assert state["generator_state"] is not None and state["callback_generator_state"] is not None
    resumed = _Recorder()
    p_res, loss_res, hist_res = manifold_informed_train(
        tm, tm.init_params(**INIT), metrics=resumed, checkpoint_path=ckpt,
        checkpoint_every=2, **kw)
    assert [r["epoch"] for r in resumed.rows] == [4, 5]
    # same generator states, same Adam moments, same scheduler state
    np.testing.assert_allclose(hist_res, hist_full[4:], rtol=1e-6)
    assert [r["lr"] for r in resumed.rows] == [r["lr"] for r in full.rows[4:]]
    for k, v in params_to_numpy(p_full).items():
        np.testing.assert_allclose(params_to_numpy(p_res)[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    assert load_training_state(tmp_path / "missing.npz", device="cpu") is None
    # resume=False ignores the file and starts over
    fresh = _Recorder()
    manifold_informed_train(tm, tm.init_params(**INIT), metrics=fresh, checkpoint_path=ckpt,
                            checkpoint_every=100, resume=False, **{**kw, "max_iter": 0})
    assert [r["epoch"] for r in fresh.rows] == [0]
    np.testing.assert_allclose(fresh.rows[0]["loss"], hist_full[0], rtol=1e-6)


def test_precond_refresh_caches_the_preconditioner(monkeypatch):
    """precond_refresh=2 over 5 epochs rebuilds at epochs 0, 2, 4 and hands
    the cached object to every loss; a stale Jacobi preconditioner changes
    CG's path, not its solution, so the trajectory stays within the CG
    tolerance of the run that rebuilds inside every loss."""
    _, tm = _models(400, max_cholesky=0, solve_cotangent="edge", cg_tolerance=1e-5)
    built = []
    real = tm.build_precond
    monkeypatch.setattr(tm, "build_precond", lambda p: built.append(1) or real(p))
    kw = dict(lr=0.1, max_iter=4, num_rand_vec=10, seed=3)
    _, _, cached = manifold_informed_train(tm, tm.init_params(**INIT), precond_refresh=2, **kw)
    assert len(built) == 3
    _, _, fresh = manifold_informed_train(tm, tm.init_params(**INIT), **kw)
    np.testing.assert_allclose(cached, fresh, rtol=1e-3)


def test_params_roundtrip_through_files_and_constraints(tmp_path):
    jm, tm = _models(300, max_cholesky=0)
    p = tm.init_params(noise=0.02, outputscale=1.5, graphbandwidth=0.3, lengthscale=2.0)
    save_params(p, tmp_path / "p.npz")
    back = load_params(tmp_path / "p.npz", device="cpu")
    assert set(back) == set(p) and all(torch.equal(back[k], p[k]) for k in p)
    # raw values carry over unchanged between models with the same constraints
    jp = jm.init_params(noise=0.02, outputscale=1.5, graphbandwidth=0.3, lengthscale=2.0)
    for k, v in params_to_numpy(p).items():
        np.testing.assert_allclose(v, np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    # ... and as constrained values where the bandwidth floors differ
    values = constrained_values(tm, p)
    np.testing.assert_allclose([values[k] for k in ("noise", "outputscale", "graphbandwidth",
                                                    "lengthscale")], [0.02, 1.5, 0.3, 2.0],
                               rtol=1e-5)
    x = tm.kernel.x.numpy()
    other = T.RiemannGP(x, tm.train_y.numpy(), T.RiemannMaternKernel(
        nu=2, x=x, nearest_neighbors=10, cfg=tm.cfg, device="cpu", graph=tm.kernel.graph,
        graphbandwidth_constraint=T.GreaterThan(0.1)), cfg=tm.cfg)
    moved = params_from_constrained(other, values)
    assert float(moved["raw_graphbandwidth"]) != pytest.approx(float(p["raw_graphbandwidth"]))
    np.testing.assert_allclose(float(other.kernel.graphbandwidth(moved)), 0.3, rtol=1e-5)
    np.testing.assert_allclose(float(other.noise(moved)), 0.02, rtol=1e-5)
