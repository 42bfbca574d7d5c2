"""A fixture for the port's CPU tests that train or run CLIs: one torch
intra-op thread for the module.

Under ``pytest -n 6`` six workers share the machine's cores, and each
worker's torch would start one OpenMP thread a core; the threads of all
workers together outnumber the cores and spin at every barrier, which
made the recon CLI test take 1232 s in a full run against 13 s alone.
Import it into a test module to use it there."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
