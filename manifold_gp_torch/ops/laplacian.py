"""Matrix-free diffusion-maps-normalized graph Laplacian (port of
``manifold_gp_tpu.ops.laplacian``).

  w_e      = exp(-d_e^2 / (4 eps^2))
  q_i      = 1 + sum_{e inc i} w_e                 (1 = the self-loop)
  w~_e     = w_e / (q_row q_col)
  d_i      = q_i^-2 + sum_{e inc i} w~_e
  diag_i   = (1 - q_i^-2 / d_i) / eps^2
  triu_e   = w~_e / (sqrt(d_row) sqrt(d_col) eps^2)

L_sym v = diag * v - A_sym v; randomwalk normalization conjugates by
D^{+-1/2} (the transpose swaps the scalings). Execution paths with the same
numerics: a pre-assembled dense L_sym, an RCM layout of
``ops.sparse_formats`` (block-ELL panels or DIA bands: a CUDA kernel or its
plain version), or the ELL gather loop.
The per-node sums over incident edges (degrees, row sums) are gather-sums
over the ELL table (``incident_sum``): unlike CUDA's ``index_add`` they sum
in a fixed order, so they repeat bit for bit on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .graph import SparseGraph


class LaplacianCoeffs(NamedTuple):
    """Per-edge/per-node Laplacian coefficients."""

    diag: torch.Tensor  # [N] Laplacian diagonal
    triu: torch.Tensor  # [M] symmetric off-diagonal values (upper tri)
    deg: torch.Tensor  # [N] density-corrected degree d_i
    deg_unnorm: torch.Tensor  # [N] unnormalized degree q_i
    weights: torch.Tensor  # [M] unnormalized edge weights w_e


class _IncidentSum(torch.autograd.Function):
    """out_i = base_i + sum of vals_e over the edges e incident to node i.

    The forward gathers each node's edge values from the ELL table into
    [1 + D, N] (base first, then the slots) and reduces over the first axis
    in one call: a fixed order on either device, where CUDA's ``index_add``
    sums in atomic order, so a rerun repeats bit for bit. It equals
    ``base.index_add(0, rows, vals).index_add(0, cols, vals)`` up to the
    order of the f32 additions. The backward is the transposed gather
    bar_vals_e = bar_out[row_e] + bar_out[col_e]."""

    @staticmethod
    def forward(ctx, graph, base, vals):
        ctx.graph = graph
        slots = torch.where(graph.ell_mask.T > 0, vals[graph.ell_edge.T], vals.new_zeros(()))
        return torch.cat([base[None], slots]).sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        bar_vals = g[graph.rows] + g[graph.cols] if ctx.needs_input_grad[2] else None
        return None, g, bar_vals


def incident_sum(graph: SparseGraph, base: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """base [N] plus, for each node, the sum of the edge values vals [M] over
    its incident edges; deterministic on every device (see _IncidentSum)."""
    if base.shape != (graph.num_nodes,):
        raise ValueError(f"incident_sum: base must be [{graph.num_nodes}], got {tuple(base.shape)}")
    return _IncidentSum.apply(graph, base, vals)


def laplacian_coeffs(graph: SparseGraph, graphbandwidth,
                     self_loops: bool = True) -> LaplacianCoeffs:
    gb = torch.as_tensor(graphbandwidth, dtype=torch.float32, device=graph.device)
    eps2 = torch.square(gb.reshape(()))
    w = torch.exp(-graph.sqdist / (4.0 * eps2)) * graph.mask
    base = 1.0 if self_loops else 0.0
    deg_unnorm = incident_sum(graph, torch.full((graph.num_nodes,), base, dtype=w.dtype,
                                          device=w.device), w)
    adj = w / (deg_unnorm[graph.rows] * deg_unnorm[graph.cols])
    deg0 = deg_unnorm**-2 if self_loops else torch.zeros_like(deg_unnorm)
    deg = incident_sum(graph, deg0, adj)
    if self_loops:
        diag = (1.0 - deg_unnorm**-2 / deg) / eps2
    else:
        diag = torch.full((graph.num_nodes,), 1.0, dtype=w.dtype, device=w.device) / eps2
    dsq = torch.sqrt(deg)
    triu = adj / (dsq[graph.rows] * dsq[graph.cols]) / eps2
    return LaplacianCoeffs(diag=diag, triu=triu, deg=deg, deg_unnorm=deg_unnorm,
                           weights=w)


def adjacency_matvec_ell(graph: SparseGraph, triu: torch.Tensor, v: torch.Tensor):
    """A_sym @ v using the padded ELL layout. v: [N, B] -> [N, B]. Loops over
    the (small) degree dimension: one row gather and one multiply-add per
    slot, O(N*B) transient memory."""
    ev = triu[graph.ell_edge] * graph.ell_mask  # [N, D]
    out = torch.zeros_like(v)
    for j in range(graph.ell_col.shape[1]):
        out = out + ev[:, j, None] * v[graph.ell_col[:, j]]
    return out


def adjacency_matvec_coo(graph: SparseGraph, triu: torch.Tensor, v: torch.Tensor):
    """A_sym @ v via two scatter-adds over the COO triu list (the reference's
    2x spmm structure, graph_laplacian_operator.py:118-119): the oracle the
    tests hold the ELL, block-ELL and DIA paths to."""
    out = torch.zeros_like(v).index_add(0, graph.rows, triu[:, None] * v[graph.cols])
    return out.index_add(0, graph.cols, triu[:, None] * v[graph.rows])


def gershgorin_bound(graph: SparseGraph, coeffs: LaplacianCoeffs):
    """Upper bound on lambda_max(L_sym): max_i (diag_i + sum_j |offdiag_ij|),
    times 1.01."""
    rowsum = incident_sum(graph, torch.zeros_like(coeffs.diag), coeffs.triu.abs())
    return torch.max(coeffs.diag + rowsum) * 1.01


def laplacian_dense(graph: SparseGraph, coeffs: LaplacianCoeffs):
    """Assemble the symmetric Laplacian L_sym as a dense [N, N] matrix."""
    n = graph.num_nodes
    a = torch.zeros((n, n), dtype=coeffs.triu.dtype, device=coeffs.triu.device)
    a.index_put_((graph.rows, graph.cols), coeffs.triu, accumulate=True)
    a.index_put_((graph.cols, graph.rows), coeffs.triu, accumulate=True)
    return torch.diag(coeffs.diag) - a


def laplacian_matvec(
    graph: SparseGraph,
    coeffs: LaplacianCoeffs,
    v: torch.Tensor,
    normalization: str = "randomwalk",
    transposed: bool = False,
    dense: Optional[torch.Tensor] = None,
    block=None,
):
    """Apply L to v ([N] or [N, B]).

    normalization='symmetric': L_sym v; 'randomwalk': D^{-1/2} L_sym D^{1/2} v
    (the transpose swaps the scalings). ``dense`` is a pre-assembled L_sym;
    ``block`` a (layout, buffer) pair of ``ops.sparse_formats`` (block-ELL
    panels or DIA bands), applied by ``sparse_formats.matvec`` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors); default is
    the ELL gather loop."""
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    if normalization == "randomwalk":
        dsq = torch.sqrt(coeffs.deg)[:, None]
        vec = v / dsq if transposed else v * dsq
    else:
        vec = v
    if block is not None:
        from .sparse_formats import matvec as fused_matvec

        out = fused_matvec(block[0], block[1], vec)
    elif dense is not None:
        out = dense @ vec
    else:
        out = coeffs.diag[:, None] * vec - adjacency_matvec_ell(graph, coeffs.triu, vec)
    if normalization == "randomwalk":
        out = out * dsq if transposed else out / dsq
    return out[:, 0] if squeeze else out


def out_of_sample(
    graph: SparseGraph,
    coeffs: LaplacianCoeffs,
    eigvec: torch.Tensor,
    edge_sqdist: torch.Tensor,
    edge_idx: torch.Tensor,
    graphbandwidth,
    normalization: str = "randomwalk",
):
    """Nystrom out-of-sample extension rows for test points: exp kernel to
    each test point's kNN training points, density-corrected by the training
    unnormalized degree and the test degree, normalized, then a weighted sum
    of training eigenvector entries.

    eigvec: [N, m]; edge_sqdist/edge_idx: [Nt, k]. Returns [Nt, m]."""
    gb = torch.as_tensor(graphbandwidth, dtype=torch.float32, device=eigvec.device)
    eps2 = torch.square(gb.reshape(()))
    out = torch.exp(-edge_sqdist / (4.0 * eps2))
    degree_test = out.sum(dim=1)
    out = out / (coeffs.deg_unnorm[edge_idx] * degree_test[:, None])
    if normalization == "symmetric":
        out = out / (torch.sqrt(coeffs.deg)[edge_idx] * torch.sqrt(out.sum(dim=1))[:, None])
    elif normalization == "randomwalk":
        out = out / out.sum(dim=1)[:, None]
    return torch.einsum("tk,tkm->tm", out, eigvec[edge_idx])
