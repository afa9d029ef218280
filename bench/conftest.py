"""Shared pieces of the benchmark's CPU tests: a tiny same-family size of
the configuration, and a traffic small enough for a CPU run."""
import pytest
import torch

#: the cells' configurations cut to a CPU test's size (every width small)
TINY = {
    "mamba2-370m": dict(n_layers=3, d_model=64, vocab=256, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=16),
}
#: the mixes cut likewise: short documents, few set-up requests
TINY_TRAFFIC = dict(prefix_len=40, warm={"requests": 20, "decodes": 2},
                    cluster={"node_capacity": 4, "update_interval": 2},
                    trace={"skip": 2, "requests": 3},
                    check={"max_forwards": 6})


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny eager ops run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
