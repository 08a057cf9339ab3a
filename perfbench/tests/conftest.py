"""Tests of the benchmark. ``-m chip`` selects the tests that need a CUDA
card; each decides inside its fixture whether there is one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with `python3 -m pytest perfbench/tests -m chip` "
                    "on the H100 machine")
    return torch.device("cuda:0")
