"""The ``chip`` marker and fixture of the benchmark's tests.

Tests that need the card carry the ``chip`` marker and skip inside the
fixture when there is none; run them on the GPU machine with
``python -m pytest bench/tests -m chip``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skipped where there is none")
    # a worker's small CPU cells gain nothing from more threads, and one
    # pool per core in each of several workers slows the run tenfold
    import torch
    torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the GPU machine)")
    return torch.device("cuda:0")
