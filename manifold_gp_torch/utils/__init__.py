from .checkpoint import load_params, load_training_state, save_params, save_training_state
from .convert import (
    constrained_values,
    params_from_constrained,
    params_from_jax,
    params_to_numpy,
)
from .evaluate import gaussian_nll, test_model
from .train import ReduceLROnPlateau, manifold_informed_train, vanilla_train

__all__ = [
    "ReduceLROnPlateau",
    "constrained_values",
    "gaussian_nll",
    "load_params",
    "load_training_state",
    "manifold_informed_train",
    "params_from_constrained",
    "params_from_jax",
    "params_to_numpy",
    "save_params",
    "save_training_state",
    "test_model",
    "vanilla_train",
]
