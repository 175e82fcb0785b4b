from .riemann import RiemannKernel, RiemannMaternKernel

__all__ = ["RiemannKernel", "RiemannMaternKernel"]
