"""Fixtures of the benchmark's own tests (`python -m pytest
benchmark/tests -q` from the root of the repository). Tests that need the
card carry the `cuda` marker and the `card` fixture, which skips them
where there is none; it decides inside the fixture, never at import."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
