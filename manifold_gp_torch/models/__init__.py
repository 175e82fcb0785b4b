from .riemann_gp import Posterior, RiemannGP
from .vanilla_gp import VanillaGP

__all__ = ["Posterior", "RiemannGP", "VanillaGP"]
