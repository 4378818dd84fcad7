"""The benchmark's own tests: `python -m pytest port_bench -q` on the CPU;
those that need the card are marked `cuda` and skip without one (run them
on the card: `python -m pytest port_bench -q -m cuda`)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
