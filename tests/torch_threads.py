"""The one-thread fixture of the port's kernel-level CPU tests, shared by import (a test file
that imports ``one_torch_thread`` takes it for each of its tests)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread, restored after: its many small CPU ops run no faster on
    more, and under the parallel test runner, with every core busy, OpenMP's threads waiting on
    each op made such a file ~35x slower (18 cases: 280 s on eight threads, 8 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
