"""One intra-op thread for the PyTorch port's CPU tests.

The port's CPU paths run many tiny tensor ops. PyTorch's intra-op pool
starts one thread a core in every process, and under pytest-xdist every
worker does so on the same cores: the pools' threads then wait on one
another, and a test that takes 2 s alone takes about 90 s beside three
busy workers. A port test module imports `one_torch_thread` (a
module-scoped autouse fixture) to run its tests on one thread and give
the worker's previous setting back afterwards, so the other modules of
the worker run as they would without it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
