from .cache import cached_eval_basis, cached_graph, clear_cache
from .checkpoint import load_params, load_training_state, save_params, save_training_state
from .convert import (
    constrained_values,
    params_from_constrained,
    params_from_jax,
    params_to_numpy,
)
from .datasets import (
    manifold_1D_dataset,
    manifold_2D_dataset,
    parse_msh,
    parse_stl,
    rmnist_dataset,
    rotate_mnist,
)
from .evaluate import gaussian_nll, gaussian_nll_stochastic, test_model
from .metrics import MetricsRecorder, count, profile_trace, span
from .multistart import multi_start_train, random_restarts
from .sampling import grid_uniform, sample_posterior
from .train import ReduceLROnPlateau, manifold_informed_train, vanilla_train

__all__ = [
    "MetricsRecorder",
    "ReduceLROnPlateau",
    "cached_eval_basis",
    "cached_graph",
    "clear_cache",
    "constrained_values",
    "count",
    "gaussian_nll",
    "gaussian_nll_stochastic",
    "grid_uniform",
    "load_params",
    "load_training_state",
    "manifold_1D_dataset",
    "manifold_2D_dataset",
    "manifold_informed_train",
    "multi_start_train",
    "params_from_constrained",
    "params_from_jax",
    "params_to_numpy",
    "parse_msh",
    "parse_stl",
    "profile_trace",
    "random_restarts",
    "rmnist_dataset",
    "rotate_mnist",
    "sample_posterior",
    "save_params",
    "save_training_state",
    "span",
    "test_model",
    "vanilla_train",
]
