"""The port on an NVIDIA GPU: the subset-DP CUDA kernel against its plain
version, and the simulator on the card against the same run on the CPU.

Every test here needs a card (``cuda`` marker) and skips without one; the
file imports nothing of JAX, so it runs on a GPU host that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none.  Subset-DP products are compared byte for byte and
argmins exactly; the exhaustive simulator results on the card equal the
CPU's field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cachesim import SimConfig, Simulator, get_trace, run_policies
from repro_torch.core.batched import _subset_dp
from repro_torch.kernels.subsetdp import ops, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _instance(rng, n, b):
    costs = rng.uniform(0.05, 5.0, n)
    rhos = rng.uniform(0.0, 1.0, (b, n))
    rhos[0] = 0.0
    rhos[1] = 1.0
    rhos[2] = 0.5                  # a row of exact ties
    return costs, rhos, float(rng.uniform(1.5, 1000.0))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 1003])
@pytest.mark.parametrize("n", [1, 4, 8, 12])
def test_kernel_matches_plain_on_card(card, n, b):
    """Products byte for byte (also against the host NumPy oracle); the
    fused argmin exactly, with and without ``allowed``, with scalar and
    per-row penalties."""
    rng = np.random.default_rng(700 + n + b)
    costs, rhos, M = _instance(rng, n, b)
    r = torch.as_tensor(rhos, device=card)
    mp = torch.as_tensor([M], dtype=torch.float64, device=card)
    prod = ops.subset_prod(r, M)
    assert torch.equal(prod, ref.subset_prod_ref(r, mp))
    assert ops.subset_dp(costs, r, M).cpu().numpy().tobytes() == \
        _subset_dp(costs, rhos, M).tobytes()
    cost = ops.subset_costs(costs, n, card)
    for pen in (M, rng.uniform(1.5, 1000.0, b)):
        pm = torch.as_tensor(np.atleast_1d(pen), dtype=torch.float64,
                             device=card)
        for allowed in (None, torch.as_tensor(
                rng.integers(0, 1 << n, b), device=card)):
            got = ops.subset_argmin(costs, r, pen, allowed=allowed)
            want = ref.subset_argmin_ref(cost, r, pm, allowed)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_counts_launches(card):
    ops.reset_launches()
    r = torch.full((5, 3), 0.5, dtype=torch.float64, device=card)
    ops.subset_argmin([1.0, 2.0, 3.0], r, 10.0)
    ops.subset_prod(r, 10.0)
    assert ops.LAUNCHES == {"subset_prod": 1, "subset_argmin": 1}


@pytest.mark.cuda
def test_exhaustive_simulation_card_equals_cpu(card):
    trace = get_trace("gradle", 8_000, seed=2)
    cfg = SimConfig(n_caches=5, costs=(1.0, 2.0, 3.0, 1.5, 2.5),
                    cache_size=800, update_interval=150, alg="exhaustive")
    policies = ("fna", "fno", "pi", "fna_cal")
    ops.reset_launches()
    got = run_policies(trace, cfg, policies, device=card)
    assert ops.LAUNCHES["subset_argmin"] > 0
    want = run_policies(trace, cfg, policies, device="cpu")
    for p in policies:
        assert dataclasses.asdict(got[p]) == dataclasses.asdict(want[p]), p


@pytest.mark.cuda
def test_fna_cal_exhaustive_launches_kernel_on_card(card):
    """The calibrated policy's exhaustive speculation tables are built by
    the kernel on the card; the result equals the CPU run's."""
    trace = get_trace("gradle", 8_000, seed=3)
    cfg = SimConfig(n_caches=5, costs=(1.0, 2.0, 3.0, 1.5, 2.5),
                    cache_size=800, update_interval=150, alg="exhaustive",
                    policy="fna_cal")
    ops.reset_launches()
    got = Simulator(cfg, card).run(trace)
    assert ops.LAUNCHES["subset_argmin"] > 0
    want = Simulator(cfg, "cpu").run(trace)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
