"""The benchmark of the PyTorch/CUDA port (``manifold_gp_torch``): one
command runs one cell once (``run.py``); configurations, traffic mixes,
kinds of loop, limits and per-layer readers are files found by name."""
