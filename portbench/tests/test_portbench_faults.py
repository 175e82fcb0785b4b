"""The output check fails what it must: the control (the reference in the
next lower precision in the program's place) and runs with the timed path
broken underneath, each at a small size on the CPU and held to the
committed limits; the same runs unbroken pass."""

from __future__ import annotations

import pytest
import torch

from _small import run_small, small_cell

from portbench.harness import check
from portbench.loops import train_jobs

TRAIN_CELLS = ("torus262k-train", "curve262k-train")


def correct(out) -> bool:
    return bool(out["verdict"][0]) and out["failed"] == 0


@pytest.mark.parametrize("name", TRAIN_CELLS + ("torus262k-serve",))
def test_sound_run_passes_and_control_fails(name):
    cell = small_cell(name)
    out = run_small(cell, control=True)
    assert correct(out), out["verdict"]
    for kind, numbers in out["control"].items():
        ok, rows = check.verdict(numbers, cell.limits["limits"])
        assert not ok, (kind, rows)


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN_CELLS + ("torus262k-serve",))
def test_small_cell_on_the_card(name, card):
    """The same at 2,000 points through the CUDA kernels, traced: sound
    runs pass, the control fails, the traced run reads its metrics."""
    cell = small_cell(name)
    out = run_small(cell, control=True, trace=True, device=card)
    assert correct(out), out["verdict"]
    assert out["metrics"] and out["busy_s"] > 0
    ok, rows = check.verdict(out["control"]["control"], cell.limits["limits"])
    assert not ok, rows


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_state_left_unchanged_fails(name, monkeypatch):
    """Every job's Adam steps move nothing (learning rate 0)."""
    import manifold_gp_torch.utils as utils

    train = utils.manifold_informed_train
    monkeypatch.setattr(utils, "manifold_informed_train",
                        lambda *a, **kw: train(*a, **{**kw, "lr": 0.0}))
    assert not correct(run_small(small_cell(name)))


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_the_probes_fails(name, monkeypatch):
    """The program gets the first half of every epoch's probe columns and
    averages over them."""
    feed = train_jobs.Loop.feed

    def half(self, job):
        f = feed(self, job)
        probes = f.probes
        f.probes = lambda epoch: probes(epoch)[:, : f.num_probes // 2]
        return f

    monkeypatch.setattr(train_jobs.Loop, "feed", half)
    assert not correct(run_small(small_cell(name)))


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("leaf", [None, 1])
def test_flipped_gradient_fails(name, leaf, monkeypatch):
    """The program's optimizer gets the gradient with its sign flipped: of
    every leaf (gradient ascent, ``leaf`` None) or of one leaf. (The
    reference's float64 steps are left as they are.)"""
    step = torch.optim.Adam.step

    def flipped(self, *a, **kw):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.dtype == torch.float32]
        for p in (params if leaf is None else params[leaf:leaf + 1]):
            if p.grad is not None:
                p.grad.neg_()
        return step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", flipped)
    assert not correct(run_small(small_cell(name)))


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_altered_loss_fails(name, monkeypatch):
    """The loss is altered where it is produced, by a thousandth of itself."""
    from manifold_gp_torch.models.riemann_gp import RiemannGP

    loss = RiemannGP.mll_loss
    monkeypatch.setattr(RiemannGP, "mll_loss",
                        lambda self, *a, **kw: loss(self, *a, **kw) * 1.001)
    assert not correct(run_small(small_cell(name)))


def test_stand_up_served_from_a_cache_fails(monkeypatch):
    """Only the first stand-up solves its basis; the others serve its cache."""
    from manifold_gp_torch.models.riemann_gp import RiemannGP

    solve = RiemannGP.eval

    def once(self, *a, **kw):
        if not hasattr(self, "_bench_solved"):
            self._bench_solved = True
            return solve(self, *a, **kw)
        return self

    monkeypatch.setattr(RiemannGP, "eval", once)
    assert not correct(run_small(small_cell("torus262k-serve")))


def test_half_the_basis_fails(monkeypatch):
    """The basis solve returns half of its modes' vectors as zeros."""
    from manifold_gp_torch.kernels.riemann import RiemannKernel

    solve = RiemannKernel.eval_basis

    def half(self, params):
        eigval, eigvec = solve(self, params)
        eigvec = eigvec.clone()
        eigvec[:, eigvec.shape[1] // 2:] = 0.0
        return eigval, eigvec

    monkeypatch.setattr(RiemannKernel, "eval_basis", half)
    assert not correct(run_small(small_cell("torus262k-serve")))


@pytest.mark.parametrize("fault", ["duplicated", "wrong_part", "flipped_order"])
def test_wrong_basis_fails(fault, monkeypatch):
    """The basis solve returns eigenpairs that are not the lowest modes:
    one mode's vector duplicated into the next ("duplicated"), the modes
    above the wanted ones ("wrong_part": the solve asked for twice as many,
    the upper half returned), or the eigenvalues in reverse order
    ("flipped_order")."""
    from manifold_gp_torch.kernels.riemann import RiemannKernel

    solve = RiemannKernel.eval_basis

    def wrong(self, params):
        if fault == "wrong_part":
            m = self.num_modes
            self.num_modes = 2 * m
            try:
                eigval, eigvec = solve(self, params)
            finally:
                self.num_modes = m
            return eigval[m:], eigvec[:, m:]
        eigval, eigvec = solve(self, params)
        if fault == "duplicated":
            eigvec = eigvec.clone()
            eigvec[:, 2] = eigvec[:, 1]
            return eigval, eigvec
        return torch.flip(eigval, [0]), eigvec

    monkeypatch.setattr(RiemannKernel, "eval_basis", wrong)
    assert not correct(run_small(small_cell("torus262k-serve")))


def test_altered_posterior_fails(monkeypatch):
    """One held-out point's posterior mean is altered where it is made."""
    from manifold_gp_torch.models.riemann_gp import Posterior, RiemannGP

    posterior = RiemannGP.posterior

    def altered(self, *a, **kw):
        post = posterior(self, *a, **kw)
        mean = post.mean.clone()
        mean[0] += 0.01 * torch.max(torch.abs(mean))
        return Posterior(mean=mean, covar=post.covar, stddev=post.stddev)

    monkeypatch.setattr(RiemannGP, "posterior", altered)
    assert not correct(run_small(small_cell("torus262k-serve")))
