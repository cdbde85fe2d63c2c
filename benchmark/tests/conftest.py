"""Settings of the benchmark's own tests: the harness and the repository
root on the path, the ``gpu`` marker, and a ``card`` fixture that skips a
test without a CUDA card (decided when the test runs, never at import)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips itself without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device('cuda:0')
