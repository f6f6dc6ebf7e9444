"""Tests of the benchmark.  They run on the CPU at tiny sizes; a test that
needs the card takes the `card` fixture, which skips without one.

    python3 -m pytest swtbench/tests -q
"""

import pytest
import torch

# the cells' tiny CPU size: 240 x 320 frames, two blocks, two windows a batch
TINY = {"height": 240, "width": 320, "blocks": 2, "batch_windows": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    return dict(TINY)
