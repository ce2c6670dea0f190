"""Tests of the benchmark itself, on the CPU at toy sizes: ``python -m pytest
portbench/tests -q`` from the repository's root. Tests that need a card
carry the ``cuda`` marker and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
