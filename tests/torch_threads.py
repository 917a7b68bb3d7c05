"""One intra-op torch thread for a test module that runs torch on the CPU
beside JAX: in the tier-1 command's six xdist workers torch's own pool of
every core, beside XLA's pools and the other workers, slowed such modules
several times over (a tiny model's demo entry point: ~1 s alone, ~120 s
there). A module takes it with
    from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
