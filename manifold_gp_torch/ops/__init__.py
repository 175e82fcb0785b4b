from .bump import bump_function
from .eigen import chebyshev_filtered_smallest
from .graph import SparseGraph, build_graph, coalesce_mean, graph_from_edges
from .knn import NearestNeighbors, knn_search
from .laplacian import (
    LaplacianCoeffs,
    adjacency_matvec_ell,
    gershgorin_bound,
    laplacian_coeffs,
    laplacian_dense,
    laplacian_matvec,
    out_of_sample,
)

__all__ = [
    "bump_function",
    "chebyshev_filtered_smallest",
    "SparseGraph",
    "build_graph",
    "coalesce_mean",
    "graph_from_edges",
    "NearestNeighbors",
    "knn_search",
    "LaplacianCoeffs",
    "adjacency_matvec_ell",
    "gershgorin_bound",
    "laplacian_coeffs",
    "laplacian_dense",
    "laplacian_matvec",
    "out_of_sample",
]
