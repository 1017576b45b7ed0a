"""A fixture for the port's CPU tests: one torch thread while a test file
runs.  The tier-1 command runs the test files in several worker processes
at once, and torch's intra-op pool (one thread per core in every worker)
then oversubscribes the cores; the port tests' tensors (32x32 frames, a
few hundred Gaussians) gain nothing from more than one thread.  Import
`one_torch_thread` into a test module to use it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
