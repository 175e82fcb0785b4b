"""Shared inputs of the port's tests.

conftest's session-scoped ``rng`` is one generator for every file that runs
on a worker, so a port test that drew from it (directly or through
``small_cloud``) would change the data of the JAX tests that run after it.
The port's tests make their inputs from generators of their own."""

import numpy as np


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
