"""Operator compositions: Matérn precision, scale / noise wrappers (port of
``manifold_gp_tpu.ops.matern``).

  * Matérn precision Q = (2 nu / l^2 I + L)^nu, applied as nu repetitions of
    ``out <- (out + (l^2/2nu) L out) / (l^2/2nu)``; for randomwalk
    normalization the output is post-multiplied by the degree to symmetrize.
    On the block-ELL path the recursion telescopes to
    Q = D^{1/2} (2nu/l^2 I + L_sym)^nu D^{1/2}: nu bare block matvecs with the
    shift folded into the panel diagonal. "Block" means either layout of
    ``ops.sparse_formats``: block-ELL panels or DIA bands.
  * Scale wrapper: multiplies (or divides, ``inverse_scale``) the matvec by a
    scalar. NOTE the training path wraps the precision with
    ``inverse_scale=False``, so "outputscale" multiplies the *precision*
    during training; the average-variance normalization protocol of
    ``utils.train`` compensates. That asymmetry is preserved exactly.
  * Noise wrapper: truncated Neumann series
    (K + s^2 I)^{-1} ~= Q - s^2 Q^2 + s^4 Q^3, evaluated as nested matvecs
    Q(v - s^2 Q(v - s^2 Q v)).
  * Schur complement (semisupervised): the labeled block's effective
    precision Q_ll - Q_lu Q_uu^{-1} Q_ul, each apply an inner CG on the
    unlabeled block: the span ``imgp.schur.apply`` and the counter
    ``schur.applies.<columns>`` (``utils.metrics``) while tracing; the inner
    solves count as ``cg.*.schur_inner`` (``ops.cg``). One form runs the
    nested solve, ``make_schur_matvec_masked``: full-length vectors and 0/1
    row masks, in whatever vector space the base operator works in (node
    order, padded-RCM order, or a rank's rows of a mesh). Compact
    [n_labeled, B] vectors meet it at one boundary, ``_at_rows``, which
    embeds them at the labeled rows and selects those rows back: the only
    index work of the Schur code, counted ``schur.gathers.<embed|select>``
    once each per apply of what it wraps. ``make_schur_matvec`` is the
    index-array entry point: the masked form over node masks behind that
    boundary. ``RiemannGP.precision_matvec`` puts the boundary outside its
    whole stack instead (Scale and Noise commute with it).

Each factory here returns an ``ops.operator.Operator``: the matvec [n, B] ->
[n, B] together with the tensors it depends on, which the solvers of
``ops.cg`` and ``ops.slq`` need to return their gradients. On a row-sharded
operator (``Operator.mesh``) the wrappers keep the mesh, and the scalars
they add enter the sharded computation through ``Operator.entered``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import row_max
from ..utils.metrics import count, span
from .block_sparse import BlockLayout
from .graph import SparseGraph
from .laplacian import LaplacianCoeffs, incident_sum, laplacian_matvec
from .operator import Operator, as_operator

_NORMALIZATIONS = ("randomwalk", "symmetric")


def _check_normalization(normalization: str):
    if normalization not in _NORMALIZATIONS:
        raise ValueError(
            "normalization must be 'randomwalk' or 'symmetric', got "
            f"{normalization!r}"
        )


def _panel_dtype_of(blocks):
    """``block[1]`` -> assemble() dtype: None (f32 panels), a dtype or the
    "float32x3" tag, or a panel buffer whose type is reused."""
    if blocks is None or not isinstance(blocks, torch.Tensor):
        return blocks
    return "float32x3" if blocks.dim() == 4 else blocks.dtype


def _shift(nu: int, lengthscale):
    return 2.0 * nu / torch.square(lengthscale.reshape(()))


def make_matern_precision_matvec(
    graph: SparseGraph,
    coeffs: LaplacianCoeffs,
    nu: int,
    lengthscale,
    normalization: str = "randomwalk",
    dense: Optional[torch.Tensor] = None,
    block=None,
    permuted_io: bool = False,
    grad_space: str = "panel",
) -> Operator:
    """Q = (2 nu / l^2 I + L)^nu (with randomwalk symmetrization).

    ``permuted_io`` (block path): the operator maps padded-RCM-space vectors
    [Np, B] -> [Np, B]; callers hoist the permutation to the solve boundary.

    ``grad_space`` (block-ELL path): "panel" (default) or "edge" — see
    ``InferenceConfig.solve_cotangent``. Edge mode bounds the solve VJPs'
    backward memory at one transient panel buffer by contracting each
    cotangent to the [M]+[N] coefficient vectors at once
    (``ops.cuda_spmv.make_matvec_edge_ad``).
    """
    lengthscale = torch.as_tensor(lengthscale, dtype=torch.float32, device=coeffs.deg.device)

    if block is not None and grad_space == "edge":
        from .cuda_spmv import make_matvec_edge_ad
        from .sparse_formats import assemble, permute_in, permute_out

        layout, blocks = block
        if not isinstance(layout, BlockLayout):
            raise ValueError(
                "solve_cotangent='edge' requires the block-ELL layout "
                "(DIA bands assemble per-diagonal, not per-panel)"
            )
        _check_normalization(normalization)
        diag_s = coeffs.diag + _shift(nu, lengthscale)
        # Assembled ONCE per coefficient set, outside the autograd graph:
        # every solve's panel cotangent is dead (the edge-space backward
        # carries the gradient).
        with torch.no_grad():
            qblocks = assemble(layout, diag_s, coeffs.triu, dtype=_panel_dtype_of(blocks))
        mv_edge = make_matvec_edge_ad(layout)
        dsq_p = torch.sqrt(coeffs.deg[layout.perm])

        def matvec(v, qblocks, diag_s, triu, dsq_p):
            squeeze = v.dim() == 1
            out = v[:, None] if squeeze else v
            if not permuted_io:
                out = permute_in(layout, out)
            if normalization == "randomwalk":
                out = out * dsq_p[:, None]
            for _ in range(nu):
                out = mv_edge(qblocks, diag_s, triu, out)
            if normalization == "randomwalk":
                out = out * dsq_p[:, None]
            if not permuted_io:
                out = permute_out(layout, out)
            return out[:, 0] if squeeze else out

        return Operator(matvec, (qblocks, diag_s, coeffs.triu, dsq_p))

    if block is not None:
        # Fused block path: the telescoped form (matern_precision_operands /
        # make_matern_precision_matvec_operand below) plus the permutation
        # boundary.
        from .sparse_formats import permute_in, permute_out

        layout, blocks = block
        qblocks, dsq_p = matern_precision_operands(
            layout, coeffs, nu, lengthscale, dtype=_panel_dtype_of(blocks)
        )
        inner = make_matern_precision_matvec_operand(layout, nu, normalization)

        def matvec(v, qblocks, dsq_p):
            squeeze = v.dim() == 1
            out = v[:, None] if squeeze else v
            if not permuted_io:
                out = permute_in(layout, out)
            out = inner(qblocks, dsq_p, out)
            if not permuted_io:
                out = permute_out(layout, out)
            return out[:, 0] if squeeze else out

        return Operator(matvec, (qblocks, dsq_p))

    # Dense / ELL recursion. ``lap`` is the dense L_sym, or (diag, triu) of
    # the ELL gather loop.
    lap = (dense,) if dense is not None else (coeffs.diag, coeffs.triu)

    def matvec(v, lengthscale, deg, *lap):
        a = torch.square(lengthscale.reshape(())) / (2.0 * nu)
        c = coeffs._replace(deg=deg)
        dense_l = None
        if len(lap) == 1:
            dense_l = lap[0]
        else:
            c = c._replace(diag=lap[0], triu=lap[1])
        out = v
        for _ in range(nu):
            lv = laplacian_matvec(graph, c, out, normalization, dense=dense_l)
            out = (out + a * lv) / a
        if normalization == "randomwalk":
            out = out * (deg if out.dim() == 1 else deg[:, None])
        return out

    return Operator(matvec, (lengthscale, coeffs.deg, *lap))


def matern_precision_operands(layout, coeffs, nu: int, lengthscale, dtype=None):
    """Assemble the per-coeffs operands of the fused Matérn matvec: the
    shift-folded panel buffer and the permuted sqrt-degree vector, so that
    callers with fixed hyperparameters can assemble once and pass both to
    ``make_matern_precision_matvec_operand``'s matvec."""
    from .sparse_formats import assemble

    lengthscale = torch.as_tensor(lengthscale, dtype=torch.float32, device=coeffs.deg.device)
    qblocks = assemble(layout, coeffs.diag + _shift(nu, lengthscale), coeffs.triu, dtype=dtype)
    dsq_p = torch.sqrt(coeffs.deg[layout.perm])
    return qblocks, dsq_p


def make_matern_precision_matvec_operand(layout, nu: int, normalization: str = "randomwalk"):
    """Operand-explicit fused Matérn matvec: ``matvec(qblocks, dsq_p, pv)``
    over permuted padded-RCM vectors, with operands from
    :func:`matern_precision_operands`; differentiable in all three
    (``ops.sparse_formats.make_matvec_ad``: panels or bands)."""
    _check_normalization(normalization)
    from .sparse_formats import make_matvec_ad

    mv_fn = make_matvec_ad(layout)

    def matvec(qblocks, dsq_p, v):
        squeeze = v.dim() == 1
        out = v[:, None] if squeeze else v
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        for _ in range(nu):
            out = mv_fn(qblocks, out)
        if normalization == "randomwalk":
            out = out * dsq_p[:, None]
        return out[:, 0] if squeeze else out

    return matvec


def matern_precision_diag(
    graph: SparseGraph,
    coeffs: LaplacianCoeffs,
    nu: int,
    lengthscale,
    normalization: str = "randomwalk",
) -> torch.Tensor:
    """(Approximate) diagonal of Q = (2 nu/l^2 I + L)^nu for Jacobi PCG.

    With A = shift*I + L_sym the diagonals are
      nu=1: diag(A)            (exact)
      nu=2: diag(A^2) = diag(A)^2 + rowsum(offdiag^2)   (exact)
      nu>2: diag(A^2)^{nu/2}   (positive surrogate; a preconditioner only
            needs a spectrally-reasonable SPD scaling, not exactness)
    and the randomwalk symmetrization multiplies by the degree
    (Q_rw = D^{1/2} A^nu D^{1/2} has diag = deg * diag(A^nu)).
    """
    lengthscale = torch.as_tensor(lengthscale, dtype=torch.float32, device=coeffs.deg.device)
    diag_a = coeffs.diag + _shift(nu, lengthscale)
    if nu == 1:
        d = diag_a
    else:
        sq = torch.square(coeffs.triu)
        off2 = incident_sum(graph, torch.zeros_like(coeffs.diag), sq)
        diag_a2 = torch.square(diag_a) + off2
        d = diag_a2 if nu == 2 else torch.pow(diag_a2, 0.5 * nu)
    if normalization == "randomwalk":
        d = d * coeffs.deg
    return d


def noisy_scaled_diag(diag_q: torch.Tensor, scale=None, noise=None) -> torch.Tensor:
    """Push a Q-diagonal estimate through the Scale and truncated-Neumann
    Noise wrappers (diagonal part only): q -> s*q -> q(1 - s2 q (1 - s2 q)).
    Clamped away from zero so the Jacobi preconditioner stays SPD even where
    the Neumann truncation would cross zero (relative to the largest entry
    over every rank's rows, on a mesh)."""
    d = diag_q
    if scale is not None:
        d = d * scale.reshape(())
    if noise is not None:
        s2 = noise.reshape(())
        d = d * (1.0 - s2 * d * (1.0 - s2 * d))
    return torch.maximum(d, 1e-12 * row_max(torch.abs(diag_q)))


def make_jacobi_precond(diag: torch.Tensor):
    """M^{-1} v = v / diag, broadcasting over the RHS batch."""

    def apply(v):
        return v / (diag if v.dim() == 1 else diag[:, None])

    return apply


def _scalar_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(float(x))


def make_scaled_matvec(matvec, scale, inverse_scale: bool = False) -> Operator:
    op = as_operator(matvec)
    scale = op.entered(_scalar_tensor(scale))

    def mv(v, *consts):
        s = consts[-1].reshape(())
        out = op.fn(v, *consts[:-1])
        return out / s if inverse_scale else out * s

    return Operator(mv, (*op.consts, scale), mesh=op.mesh)


def make_noisy_matvec(matvec, noise) -> Operator:
    """Truncated-Neumann noisy precision Q - s2 Q^2 + s2^2 Q^3."""
    op = as_operator(matvec)
    noise = op.entered(_scalar_tensor(noise))

    def mv(v, *consts):
        s2 = consts[-1].reshape(())
        q = lambda u: op.fn(u, *consts[:-1])  # noqa: E731
        return q(v - s2 * q(v - s2 * q(v)))

    return Operator(mv, (*op.consts, noise), mesh=op.mesh)


def _at_rows(op: Operator, rows: torch.Tensor, n: int) -> Operator:
    """``op`` (on [n, B] vectors) on compact [len(rows), B] ones: each apply
    embeds at ``rows`` of an n-row zero vector, applies ``op`` and selects
    those rows back. The boundary of a Schur complement that acts on
    vectors supported on ``rows`` (``schur.gathers.embed`` / ``.select``,
    once each per apply). Shares ``op``'s ``consts``; one device only."""

    def fn(v, *consts):
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        count("schur.gathers.embed")
        out = op.fn(vv.new_zeros((n, vv.shape[1])).index_copy(0, rows, vv), *consts)
        count("schur.gathers.select")
        out = out.index_select(0, rows)
        return out[:, 0] if squeeze else out

    return Operator(fn, op.consts)


def make_schur_matvec(
    base_matvec,
    labeled_idx,
    unlabeled_idx,
    n: int,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 1000,
    precond_diag: Optional[torch.Tensor] = None,
) -> Operator:
    """Effective labeled-block precision S = Q_ll - Q_lu Q_uu^{-1} Q_ul on
    compact [n_labeled, B] vectors: ``make_schur_matvec_masked`` over the
    node masks of ``labeled_idx`` / ``unlabeled_idx`` (index arrays,
    ``labeled_split``), behind the boundary that embeds at the labeled rows
    and selects them back (``_at_rows``). ``precond_diag``: optional [n]
    diagonal of the base operator; the inner CG then runs
    Jacobi-preconditioned. Shares the base operator's ``consts``."""
    base = as_operator(base_matvec)
    if precond_diag is not None:
        device = precond_diag.device
    else:
        device = base.consts[0].device if base.consts else torch.device("cpu")
    li = torch.as_tensor(np.asarray(labeled_idx), dtype=torch.int64, device=device)
    ui = torch.as_tensor(np.asarray(unlabeled_idx), dtype=torch.int64, device=device)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    masked = make_schur_matvec_masked(base, zeros.index_fill(0, li, 1.0),
                                      zeros.index_fill(0, ui, 1.0), cg_tol=cg_tol,
                                      cg_max_iter=cg_max_iter, precond_diag=precond_diag)
    return _at_rows(masked, li, n)


def make_schur_matvec_masked(
    base_matvec,
    mask_labeled: torch.Tensor,
    mask_unlabeled: torch.Tensor,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 1000,
    precond_diag: Optional[torch.Tensor] = None,
) -> Operator:
    """Full-space masked Schur complement, the shard-friendly form: on
    full-length vectors supported on the labeled rows, with M_l / M_u the
    0/1 row masks,

        S v = M_l (Q v - Q M_u sol),   (M_u Q M_u + (I - M_u)) sol = M_u Q v,

    which equals Q_ll - Q_lu Q_uu^{-1} Q_ul embedded at the labeled rows
    (the identity on the complement keeps the inner operator SPD and the
    solution supported on the unlabeled rows). Every step is an
    elementwise mask, so on a row-sharded base operator the whole nested
    solve stays on each rank's rows. ``precond_diag``: the base operator's
    diagonal on the same rows; the inner CG then runs Jacobi-preconditioned
    (1.0 off the unlabeled rows; detached: a preconditioner gets no
    gradient).

    The result shares the base operator's ``consts`` and mesh; its ``fn``
    builds the inner operator over the tensors it is handed, so the inner
    solve's backward returns their cotangents (what ``jax.closure_convert``
    does for the JAX package's nested ``cg_solve``). An inner operator that
    closed over the tensors instead would drop the gradient through the
    solve."""
    from .cg import cg_solve

    base = as_operator(base_matvec)
    ml = mask_labeled[:, None]
    mu = mask_unlabeled[:, None]
    inner_precond = None
    if precond_diag is not None:
        d = precond_diag.detach()
        inner_precond = make_jacobi_precond(torch.where(mask_unlabeled > 0, d,
                                                        torch.ones_like(d)))

    def inner_fn(u, *consts):
        return mu * base.fn(mu * u, *consts) + (1.0 - mu) * u

    def fn(v, *consts):
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        count(f"schur.applies.{vv.shape[1]}")
        with span("imgp.schur.apply"):
            t = base.fn(ml * vv, *consts)
            sol = cg_solve(Operator(inner_fn, consts, mesh=base.mesh), mu * t, tol=cg_tol,
                           max_iter=cg_max_iter, precond=inner_precond, log_label="schur_inner")
            out = ml * (t - base.fn(mu * sol, *consts))
        return out[:, 0] if squeeze else out

    return Operator(fn, base.consts, mesh=base.mesh)


def labeled_split(labeled_mask):
    """Boolean mask [N] -> (labeled_idx, unlabeled_idx) numpy index arrays."""
    mask = np.asarray(labeled_mask, bool)
    return np.flatnonzero(mask), np.flatnonzero(~mask)
