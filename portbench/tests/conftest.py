"""CPU tests of the benchmark at a tiny size; ``cuda`` tests need the card.

    python -m pytest portbench/tests -q -p no:cacheprovider

The card check happens inside the ``cuda_device`` fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    return 'cuda'
