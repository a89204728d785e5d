"""Tests of the benchmark harness.  They run on the CPU at small sizes;
those that need the card carry the `card` marker and skip here (the
`card` fixture decides, at run time, whether a CUDA device is present).

    python -m pytest h100bench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def root():
    return ROOT


@pytest.fixture(autouse=True)
def _cwd_root(monkeypatch):
    monkeypatch.chdir(ROOT)
