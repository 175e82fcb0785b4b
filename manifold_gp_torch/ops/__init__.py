from .bump import bump_function
from .cg import cg_raw, cg_solve
from .eigen import (
    chebyshev_filtered_smallest,
    host_f64_smallest,
    lanczos_eigh,
    lobpcg_smallest,
)
from .engine import average_variance, densify, inv_quad, logdet, solve
from .graph import SparseGraph, build_graph, coalesce_mean, graph_from_edges
from .knn import NearestNeighbors, knn_search
from .laplacian import (
    LaplacianCoeffs,
    adjacency_matvec_coo,
    adjacency_matvec_ell,
    gershgorin_bound,
    laplacian_coeffs,
    laplacian_dense,
    laplacian_matvec,
    out_of_sample,
)
from .matern import (
    labeled_split,
    make_matern_precision_matvec,
    make_noisy_matvec,
    make_scaled_matvec,
    make_schur_matvec,
)
from .slq import lanczos_batched, rademacher_probes, slq_logdet

__all__ = [
    "bump_function",
    "cg_raw",
    "cg_solve",
    "chebyshev_filtered_smallest",
    "host_f64_smallest",
    "lanczos_eigh",
    "lobpcg_smallest",
    "average_variance",
    "densify",
    "inv_quad",
    "logdet",
    "solve",
    "SparseGraph",
    "build_graph",
    "coalesce_mean",
    "graph_from_edges",
    "NearestNeighbors",
    "knn_search",
    "LaplacianCoeffs",
    "gershgorin_bound",
    "adjacency_matvec_coo",
    "adjacency_matvec_ell",
    "laplacian_coeffs",
    "laplacian_dense",
    "laplacian_matvec",
    "out_of_sample",
    "labeled_split",
    "make_matern_precision_matvec",
    "make_noisy_matvec",
    "make_scaled_matvec",
    "make_schur_matvec",
    "lanczos_batched",
    "rademacher_probes",
    "slq_logdet",
]
