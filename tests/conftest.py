"""The port's test modules (``test_torch_*``) share the machine's cores
fairly among the test workers: each worker's torch takes
``os.cpu_count() // workers`` intra-op threads (at least one), where
``workers`` is pytest-xdist's worker count (1 without xdist, so a
single-process run keeps every core).  Left at torch's default, every
worker starts one thread a core, and several workers at once spend
most of their time fighting over the cores."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _fair_threads(request):
    if not request.module.__name__.rpartition(".")[2].startswith(
            "test_torch_"):
        yield
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
