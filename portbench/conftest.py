"""The benchmark's tests: ``pytest portbench/tests``. Tests that need the
card carry the ``chip`` marker and skip, with the reason, where no CUDA
card is present (decided in the ``card`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (runs on the chip only)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
