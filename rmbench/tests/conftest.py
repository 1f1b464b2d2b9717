"""The benchmark's own tests: CPU tests at tiny sizes through the port's
plain paths, and tests marked ``cuda`` that need the card (they skip
inside the test without one). Run from the root of the checkout:

    python -m pytest rmbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU "
        "mode); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
