"""One PyTorch intra-op thread for the port's search-path test modules.

Their searches run on tensors of tens to a few thousand elements, where
PyTorch's thread pool costs more than it gives (its idle threads spin:
a two-stage CLI run on ncf takes several times the CPU time with the
default pool as with one thread, for the same bits), and the test
workers share the machine's cores.  A module imports
``one_torch_thread`` (an autouse fixture) and runs its port subprocesses
with ``ONE_THREAD`` in their environment.
"""
import pytest
import torch

ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
