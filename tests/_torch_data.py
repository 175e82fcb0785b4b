"""Shared inputs of the port's tests.

conftest's session-scoped ``rng`` is one generator for every file that runs
on a worker, so a port test that drew from it (directly or through
``small_cloud``) would change the data of the JAX tests that run after it.
The port's tests make their inputs from generators of their own."""

import numpy as np
import pytest
import torch


def small_cloud():
    """conftest's ``small_cloud`` (160-point noisy circle in 2D) as drawn
    from a fresh ``default_rng(1337)``."""
    rng = np.random.default_rng(1337)
    n = 160
    t = np.sort(rng.uniform(0, 2 * np.pi, n))
    x = np.stack([np.cos(t), np.sin(t)], axis=1)
    x += 0.01 * rng.standard_normal(x.shape)
    y = np.sin(3 * t)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's PyTorch CPU work on one thread (import the name
    into the module to switch it on). After each parallel region PyTorch's
    OpenMP workers spin for a while; in a test that alternates PyTorch and
    JAX calls, on a machine whose cores are shared with other test workers,
    those spinning threads starve JAX's: the 5,000-node loss test took 290 s
    beside five busy workers and 12 s on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
