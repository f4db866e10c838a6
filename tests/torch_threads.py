"""The port's in-process test modules run torch at one intra-op thread.

The suite runs in several pytest-xdist workers side by side, each of
which would otherwise start torch's default thread count (one a core):
beside each other they only thrash. A module imports the autouse
fixture (``from torch_threads import one_thread  # noqa: F401``), which
sets one thread for the module and restores the count after it, since a
worker runs further modules in the same process.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
