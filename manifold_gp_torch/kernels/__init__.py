from .euclidean import EuclideanKernel, MaternKernel, RBFKernel
from .riemann import RiemannKernel, RiemannMaternKernel

__all__ = [
    "EuclideanKernel",
    "MaternKernel",
    "RBFKernel",
    "RiemannKernel",
    "RiemannMaternKernel",
]
