"""An operator together with the tensors it depends on.

JAX turns a matvec closure that captures traced values into explicit
arguments with ``jax.closure_convert``, so that the custom VJPs of
``ops.cg`` and ``ops.slq`` can return cotangents for them. PyTorch has no
counterpart: a ``torch.autograd.Function`` connects only the tensors it
receives as inputs. So every matvec factory of the port returns an
``Operator``: a function ``fn(v, *consts)`` and the tuple ``consts`` of
tensors (hyperparameters, Laplacian coefficients, panels) it reads.
Wrappers compose by appending to ``consts``; the solvers pass ``consts``
into their Functions and differentiate ``fn`` with respect to them.

``mesh``: the ``parallel.mesh.Mesh`` of a row-sharded operator (None on one
device). Its vectors are this rank's rows; a replicated tensor a wrapper
appends to ``consts`` passes through ``parallel.mesh.enter_sharded`` first
(``Operator.entered``), so that its gradient sums every rank's partial
cotangent.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


class Operator:
    """Linear map ``v -> fn(v, *consts)``; call it like the closure it
    replaces."""

    __slots__ = ("fn", "consts", "mesh")

    def __init__(self, fn: Callable, consts: Sequence[torch.Tensor] = (), mesh=None):
        self.fn = fn
        self.consts = tuple(consts)
        self.mesh = mesh

    def __call__(self, v):
        return self.fn(v, *self.consts)

    def entered(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a replicated tensor about to join ``consts``, as the
        sharded computation takes it (itself on one device)."""
        if self.mesh is None:
            return t
        from ..parallel.mesh import enter_sharded

        return enter_sharded(t, self.mesh)


def as_operator(matvec) -> Operator:
    """An ``Operator`` as it is; any other callable as an operator without
    tensors (no gradient reaches what it captures)."""
    if isinstance(matvec, Operator):
        return matvec
    return Operator(matvec)
