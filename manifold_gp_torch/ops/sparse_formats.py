"""Sparse-layout format dispatch: block-ELL panels vs DIA bands (port of
``manifold_gp_tpu.ops.sparse_formats``).

Two formats share one permuted-space calling convention: the layout is
built once per graph, ``assemble`` once per coefficient change,
``matvec_permuted`` in the solver loop, ``permute_in``/``permute_out`` at
solve boundaries, ``make_matvec_ad`` for the differentiable matvec:

  * ``ops.dia``          — diagonal-offset bands for banded RCM orderings
                           (kernel K4, ``csrc/dia_spmv.cu``);
  * ``ops.block_sparse`` — 128x128 panels for general graphs (kernels
                           K1/K2 and K3 of ``ops.cuda_spmv``).

``build_layout`` picks DIA whenever the reordered graph is banded enough, as
the JAX package does; every function here dispatches on the layout type, so
operator, kernel and model code is format-agnostic.

Spans (``utils.metrics``): ``imgp.layout.build`` (set-up, always timed into
the totals) and ``imgp.operator.assemble``.
"""

from __future__ import annotations

from typing import Optional, Union

from ..utils.metrics import span, spanned
from . import block_sparse, cuda_spmv, dia
from .block_sparse import BlockLayout
from .dia import DiaLayout
from .graph import SparseGraph

Layout = Union[BlockLayout, DiaLayout]

__all__ = ["Layout", "build_layout", "assemble", "matvec", "matvec_permuted",
           "make_matvec_ad", "permute_in", "permute_out"]


def build_layout(
    graph: SparseGraph,
    max_blocks_cap: int = 40,
    dia_max_offsets: int = 24,
    use_dia: bool = True,
) -> Optional[Layout]:
    """RCM-reorder the graph into DIA bands when it has at most
    ``dia_max_offsets`` distinct diagonals (and ``use_dia``), else into
    block-ELL panels; None when neither applies."""
    with span("imgp.layout.build", total=True):
        if use_dia:
            layout = dia.build_dia_layout(graph, max_offsets=dia_max_offsets)
            if layout is not None:
                return layout
        return block_sparse.build_block_layout(graph, max_blocks_cap=max_blocks_cap)


@spanned("imgp.operator.assemble")
def assemble(layout: Layout, diag, triu, dtype=None):
    if isinstance(layout, DiaLayout):
        # DIA products are plain f32 FMAs: the x3 split buys nothing, so
        # "float32x3" keeps exact f32 bands, as in the JAX package.
        return dia.assemble(layout, diag, triu, dtype=None if dtype == "float32x3" else dtype)
    return block_sparse.assemble(layout, diag, triu, dtype=dtype)


def matvec_permuted(layout: Layout, buf, pv):
    """L_sym @ pv in permuted space through the layout's kernel dispatch."""
    if isinstance(layout, DiaLayout):
        return dia.dia_matvec_call(layout, buf, pv)
    return cuda_spmv.block_matvec(layout, buf, pv)


def permute_in(layout: Layout, v):
    if isinstance(layout, DiaLayout):
        return dia.permute_in(layout, v)
    return block_sparse.permute_in(layout, v)


def permute_out(layout: Layout, pv):
    if isinstance(layout, DiaLayout):
        return dia.permute_out(layout, pv)
    return block_sparse.permute_out(layout, pv)


def make_matvec_ad(layout: Layout):
    """Differentiable ``mv(buf, pv)`` in permuted space: DIA bands (f32 or
    bf16) or block-ELL panels (f32, bf16 or x3)."""
    if isinstance(layout, DiaLayout):
        return dia.make_matvec_ad(layout)
    return cuda_spmv.make_matvec_ad(layout)


def matvec(layout: Layout, buf, v):
    """L_sym @ v in original node order (permute boundary included)."""
    if isinstance(layout, DiaLayout):
        return dia.matvec(layout, buf, v)
    return cuda_spmv.matvec(layout, buf, v)
