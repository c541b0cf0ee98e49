"""pytest settings of the benchmark's own tests (benchmark/tests):
the benchmark's directory and the checkout on the path, and the `card`
marker of tests that need an NVIDIA card. Those ask for the `card`
fixture, which skips them where no card is present; run them on the
chip with `python3 -m pytest benchmark/tests -m card -p no:cacheprovider
-n 0`."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    """The card, or a skip where none is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda", 0)


@pytest.fixture
def one_thread():
    """One torch thread: the tiny runs launch many small ops, which
    oversubscribed thread pools slow by orders of magnitude."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

