"""Tests of the benchmark itself, run on the CPU with

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA card and skip elsewhere; on the card:
``python -m pytest portbench/tests -q -m card``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def root():
    return ROOT
