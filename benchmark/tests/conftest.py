"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository. They run on the CPU, at a small size; the tests
marked ``card`` need a CUDA card and skip without one (the fixture decides,
never at import)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")
