from .riemann_gp import Posterior, RiemannGP

__all__ = ["Posterior", "RiemannGP"]
