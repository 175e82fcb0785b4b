"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip without one;
whether a card is present is decided inside the ``card`` fixture, never
while a module is imported."""

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
