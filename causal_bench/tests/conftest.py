"""The benchmark's CPU tests run tiny cells whose every tensor operation
is small: one intra-op thread each, so that several test workers
sharing the machine's cores do not starve one another."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
