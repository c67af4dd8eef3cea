"""Tests of the port's benchmark: `python3 -m pytest portbench -q`.  Those
marked ``chip`` need a CUDA card and skip without one; on the card run
`python3 -m pytest portbench -q -m chip`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
