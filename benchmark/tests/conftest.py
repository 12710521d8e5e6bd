"""Tests of the port's benchmark.  They run on the CPU at small genome
lengths (run.run(..., device="cpu", genome_length=...)); tests that need
the card carry the `gpu` marker and decide inside a fixture.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
