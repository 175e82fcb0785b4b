"""Preconditioners (port of ``manifold_gp_tpu.ops.pivchol``, Jacobi only).

A preconditioner never changes solutions, so its tensors are detached: its
parameter dependence must not leak into gradients.

Not ported yet: the pivoted-Cholesky, deflation, conjugated and masked
classes and their factories.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiagPrecond:
    """M = diag(d) (Jacobi)."""

    d: torch.Tensor  # [n] > 0

    def apply(self, v):
        return v / (self.d if v.dim() == 1 else self.d[:, None])


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported yet (ROADMAP queue 1, 'Preconditioners and the "
        "mBCG log-det'); use precond_type='jacobi' or 'none'"
    )


def pivoted_cholesky(*args, **kwargs):
    _not_ported("pivoted_cholesky")


def make_pivchol_precond(*args, **kwargs):
    _not_ported("make_pivchol_precond")


def make_pivchol_precond_masked(*args, **kwargs):
    _not_ported("make_pivchol_precond_masked")


def make_deflation_precond(*args, **kwargs):
    _not_ported("make_deflation_precond")


class _NotPorted:
    def __init__(self, *args, **kwargs):
        _not_ported(type(self).__name__)


class LowRankDiagPrecond(_NotPorted):
    pass


class DeflationPrecond(_NotPorted):
    pass


class ConjugatedPrecond(_NotPorted):
    pass


class MaskedDiagPrecond(_NotPorted):
    pass


class MaskedLowRankDiagPrecond(_NotPorted):
    pass
