"""The benchmark's tests run a few CPU threads each."""
from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
