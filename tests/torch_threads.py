"""Test helpers of the port that import nothing of the JAX package."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny models: the suite runs
    on several workers at once, where torch's default thread pool (one
    thread a core, in every worker) stalls each small op at its
    barrier. A module takes it with ``from torch_threads import
    one_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
