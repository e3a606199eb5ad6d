"""A fixture for the port's CPU tests of large transforms.

The suite runs several test processes at once. PyTorch's own CPU threads
on top of them (one per core in each process) slow the element-wise ops of
an N = 2^17 transform many times over, so a module that imports this
fixture runs its tests on one PyTorch thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
