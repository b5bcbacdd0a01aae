"""The benchmark's own tests: on the CPU at tiny sizes, and (marker `card`)
on the card at the cells' sizes.

    python3 -m pytest gpubench/tests -q              # the CPU tests; card tests skip
    python3 -m pytest gpubench/tests -q -m card -s   # on a machine with the card

Whether a card is present is decided inside the `card` fixture, never while
a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
