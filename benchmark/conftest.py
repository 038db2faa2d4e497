"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): one marker, ``chip``, for the tests that need a CUDA
card; they decide inside the ``cuda_device`` fixture whether one is there
and skip on a host without it."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (run on the card: python -m pytest benchmark/tests -q -m chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: this test is of a host without one")
