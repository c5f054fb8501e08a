"""The port's test files import ``one_torch_thread``, an autouse fixture
that holds torch's intra-op thread count at one while a file's tests run
and restores it after.

The suite runs several pytest workers on one machine.  At one thread per
core in each worker, the port's small-op tests ran 5-18x slower beside
five other workers than alone, most likely because a parallel region
waits for threads that the other workers keep off the cores: the grid
GFlowNet's 300 training steps take 5 s alone at either count, took 93 s
in the full run at eight threads and 14 s at one."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
