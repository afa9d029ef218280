"""The port on an NVIDIA GPU: the subset-DP and Bloom-probe CUDA kernels
against their plain versions, and the simulator on the card against the
same run on the CPU.

Every test here needs a card (``cuda`` marker) and skips without one; the
file imports nothing of JAX, so it runs on a GPU host that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none.  Subset-DP products are compared byte for byte and
argmins exactly; Bloom indications exactly; the exhaustive simulator
results on the card equal the CPU's field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cachesim import SimConfig, Simulator, get_trace, run_policies
from repro_torch.core.batched import _subset_dp
from repro_torch.kernels import bloom
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


def _bloom_instance(rng, n, mbytes, k, n_keys, dev):
    """n bitmaps of 400 members each (seeds 0..n-1) and keys mixing those
    members with int32 extremes and unseen keys, all on ``dev``."""
    members = [rng.integers(-2 ** 31, 2 ** 31, 400).astype(np.int32)
               for _ in range(n)]
    bits = torch.stack([bloom.build_indicator(torch.as_tensor(m, device=dev),
                                              mbytes * 8, k, j)
                        for j, m in enumerate(members)])
    keys = np.concatenate([np.concatenate(members)[::3],
                           rng.integers(-2 ** 31, 2 ** 31, n_keys),
                           [-2 ** 31, 2 ** 31 - 1, -1, 0]]).astype(np.int32)
    return bits, torch.as_tensor(keys, device=dev), members


@pytest.mark.cuda
@pytest.mark.parametrize("mbytes,k,n,n_keys", [
    (2048, 7, 2, 256), (4096, 10, 5, 512), (2048, 3, 1, 300),
    (1750, 10, 8, 600), (1, 4, 3, 100)])
def test_bloom_kernel_matches_plain_on_card(card, mbytes, k, n, n_keys):
    """The kernel equals the plain version for int32 and int64 keys, with
    default and custom seeds; members always answer 1."""
    rng = np.random.default_rng(mbytes + n)
    bits, keys, members = _bloom_instance(rng, n, mbytes, k, n_keys, card)
    assert torch.equal(bits.cpu()[0], bloom.build_indicator(
        torch.as_tensor(members[0]), mbytes * 8, k, 0))
    seeds = [int(s) for s in rng.integers(-2 ** 40, 2 ** 40, n)]
    for kk in (keys, keys.to(torch.int64) + (5 << 32)):
        for sd in (None, seeds):
            got = bloom.bloom_probe(bits, kk, k=k, seeds=sd)
            want = bloom.bloom_probe_ref(bits, kk, k, seeds=sd)
            assert got.dtype == torch.int8 and torch.equal(got, want)
    for j, m in enumerate(members):
        got = bloom.bloom_probe(bits, torch.as_tensor(m, device=card), k=k)
        assert got.shape == (m.size, n) and bool(got[:, j].all())


@pytest.mark.cuda
def test_bloom_kernel_bitmap_larger_than_l2(card):
    """One 64 MB bitmap (more than the H100's 50 MB L2): the kernel equals
    the plain version and answers 1 for every member."""
    mbytes, k = 64 << 20, 10
    members = torch.arange(0, 30_000_000, 7, device=card)
    bits = bloom.build_indicator(members, mbytes * 8, k, 3)[None]
    keys = torch.cat([members[::50], torch.randint(
        0, 2 ** 31, (200_000,), device=card,
        generator=torch.Generator(card).manual_seed(0))])
    got = bloom.bloom_probe(bits, keys, k=k, seeds=[3])
    assert torch.equal(got, bloom.bloom_probe_ref(bits, keys, k, seeds=[3]))
    assert bool(got[: members[::50].shape[0]].all())


@pytest.mark.cuda
def test_bloom_kernel_counts_launches_and_rejects_bad_inputs(card):
    bits = torch.zeros((2, 64), dtype=torch.uint8, device=card)
    keys = torch.arange(10, device=card)
    bloom.reset_launches()
    bloom.bloom_probe(bits, keys, k=3)
    bloom.bloom_probe(bits, keys.to(torch.int32), k=3)
    assert bloom.LAUNCHES == {"bloom_probe": 2}
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits.to(torch.int32), keys, k=3)
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits, keys.to(torch.float32), k=3)
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits, keys.to(torch.int16), k=3)
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits.t(), keys, k=3)
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits, keys[::2], k=3)
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits, keys.cpu(), k=3)
    assert bloom.LAUNCHES == {"bloom_probe": 2}
