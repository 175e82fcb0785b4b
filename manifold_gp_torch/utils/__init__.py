from .convert import params_from_jax, params_to_numpy
from .evaluate import gaussian_nll, test_model

__all__ = ["gaussian_nll", "params_from_jax", "params_to_numpy", "test_model"]
