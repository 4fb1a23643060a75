"""The benchmark's own tests.  `card` marks the ones that need an NVIDIA
card; they skip on a machine without one (decided in the fixture, never
at import).  Run them all with `python -m pytest ovbench/checks -q`; on the
card the marked ones run the full-width comparisons."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false here")
    return torch.device("cuda", 0)
