"""Tests of the benchmark. `card` marks the tests that need a CUDA card;
each decides inside its fixture whether one is there and skips without
it. Run the card tests on the card with

    python3 -m pytest perfbench/tests -m card -p no:cacheprovider -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
