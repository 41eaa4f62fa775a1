"""The module fixture that pins torch to one intra-op thread, for the port's
test files (``from tests.torch_threads import one_thread``)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny engines' small ops run no slower on it,
    and the suite's workers share the machine's cores (more threads a
    worker oversubscribe them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
