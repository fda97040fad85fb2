"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Tests marked ``gpu`` need a card and skip without
one (on the card: ``python -m pytest benchmark/tests -q -m gpu``)."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

