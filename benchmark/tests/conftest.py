"""Fixtures of the benchmark's own tests, which run on the CPU."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
