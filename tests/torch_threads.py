"""One intra-op thread for the port's CPU tests.

The port's CPU tests run reduced models on a few rows, where one PyTorch
intra-op thread is as fast as many. With several test processes side by
side, each process's full-width thread pool contends with the others'
for the same cores and slows every PyTorch call many times over. A test
module that imports ``one_intra_op_thread`` runs with one thread and
puts the previous count back when it ends.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
