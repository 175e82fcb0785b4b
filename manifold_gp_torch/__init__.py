"""manifold_gp_torch — implicit-manifold Gaussian process regression in
PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

A port of ``manifold_gp_tpu`` (the JAX reference, kept beside it): the same
module paths, public names and params dicts, so one test can run both
packages on the same inputs. Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``. The port imports nothing of JAX or of
the JAX package.

f32 matrix products run in full f32: TF32 is switched off at import, the
counterpart of the JAX package's "highest" matmul precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import DEFAULT_CONFIG, InferenceConfig, resolve_device  # noqa: E402
from .kernels import MaternKernel, RBFKernel, RiemannKernel, RiemannMaternKernel  # noqa: E402
from .models import Posterior, RiemannGP, VanillaGP  # noqa: E402
from .parameters import GreaterThan, Interval, Positive  # noqa: E402
from .priors import GammaPrior, InverseGammaPrior, NormalPrior  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "InferenceConfig",
    "resolve_device",
    "MaternKernel",
    "RBFKernel",
    "RiemannKernel",
    "RiemannMaternKernel",
    "Posterior",
    "RiemannGP",
    "VanillaGP",
    "GreaterThan",
    "Interval",
    "Positive",
    "GammaPrior",
    "InverseGammaPrior",
    "NormalPrior",
]
