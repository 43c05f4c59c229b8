"""The benchmark's own tests: ``python -m pytest rtbench/tests -q``. Tests
marked ``requires_cuda`` run on a card and skip without one."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card only")
    return torch.device("cuda")


@pytest.fixture
def in_repo(monkeypatch):
    """Run from the repository's root, where the manifest's paths resolve."""
    monkeypatch.chdir(REPO)
    return REPO
