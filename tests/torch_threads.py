"""A module fixture shared by the port's full-width CPU tests: their torch
work on one intra-op thread, restored after. The suite runs in several
worker processes at once, and a full-width model's CPU kernels slow down
many times over when every worker runs as many threads as there are
cores. A test module takes it with `from .torch_threads import
torch_one_thread`."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
