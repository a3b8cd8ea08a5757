"""Settings of the benchmark's own tests (``python -m pytest servebench``).

Tests marked ``card`` need an NVIDIA card; each asks for the ``card``
fixture, which decides at run time whether one is there and skips
otherwise.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
