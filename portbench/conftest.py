"""The benchmark's tests: they run on the CPU at tiny sizes, but for those
marked ``card``, which need an NVIDIA card and skip without one. Whether
there is a card is decided in the ``card`` fixture, never at import."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.join(os.path.dirname(HERE), "src"), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
