"""pytest settings of the benchmark's own tests (``python -m pytest
port_bench/tests``): the ``cuda`` marker, and the fixture that decides, when
a test runs, whether a card is there."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")
