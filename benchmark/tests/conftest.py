"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``card`` that run on a CUDA device at the cells' sizes and skip elsewhere
(``python3 -m pytest benchmark/tests -m card`` on the card's machine)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is found (decided here, when the
    test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
