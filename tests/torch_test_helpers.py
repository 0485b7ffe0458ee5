"""Fixtures shared by the port's CPU tests.

A test module takes one by importing it by name, e.g.
``from torch_test_helpers import one_thread  # noqa: F401``; pytest
then finds it in the module's namespace."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the test run's parallel workers
    share the host's cores, and tiny ops spread over every core stall on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
