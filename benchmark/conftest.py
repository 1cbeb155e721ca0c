"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker, and a fixture that skips a test
marked so when no CUDA card is present, decided when the test runs."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this test runs the cells' control at their own size on the card")
    return torch.device("cuda")
