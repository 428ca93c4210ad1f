"""One torch thread for the port's CPU tests, and a test of it.

The suite runs in several pytest-xdist workers on one machine. Each
worker's torch would start a thread per core for every parallel operation
of the tiny detectors, whose tensors are far too small to gain from them;
the workers' threads then contend for the cores with each other and with
the JAX package's compilations. Importing :func:`one_torch_thread` into a
test module runs that module's tests (its module-scoped fixtures too, which
autouse orders after this one) on one torch thread and restores the count
after them.
"""
import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_module_runs_on_one_torch_thread():
    """The fixture is autouse here too: this module's tests see one
    thread."""
    assert torch.get_num_threads() == 1
