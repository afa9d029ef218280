"""The port on an NVIDIA GPU: the subset-DP, Bloom-probe, flash-attention
and SSD CUDA kernels against their plain versions, and the simulator and
the reduced serving path on the card against the same runs on the CPU.

Every test here needs a card (``cuda`` marker) and skips without one; the
file imports nothing of JAX, so it runs on a GPU host that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none for the simulator's kernels.  Subset-DP products are
compared byte for byte and argmins exactly; Bloom indications exactly; the
exhaustive simulator results on the card equal the CPU's field for field.
The LM kernels are float32 arithmetic in another summation order: each
test states its tolerance.  The grid layer on the card (an exhaustive
penalty grid, a store round trip) equals the CPU's field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cachesim import (ArtifactStore, SimConfig, Simulator,
                                  get_trace, run_grid, run_policies)
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
@pytest.mark.parametrize("n", list(range(1, 17)))
def test_kernel_every_n_matches_plain_on_card(card, n):
    """Every unrolled row-per-thread instance (n <= 8) and the warp-per-row
    path (n > 8): products byte for byte and the argmin exactly, with no
    ``allowed``, ``allowed`` = 0 and all ones, random ``allowed``, the
    table builders' pattern layout, scalar and per-row penalties, on a
    ragged row count."""
    rng = np.random.default_rng(800 + n)
    b = 1003 if n <= 12 else 129
    costs, rhos, M = _instance(rng, n, b)
    r = torch.as_tensor(rhos, device=card)
    mp = torch.as_tensor([M], dtype=torch.float64, device=card)
    assert torch.equal(ops.subset_prod(r, M), ref.subset_prod_ref(r, mp))
    cost = ops.subset_costs(costs, n, card)
    full = (1 << n) - 1
    for pen in (mp, torch.as_tensor(rng.uniform(1.5, 1000.0, b),
                                    device=card)):
        for allowed in (None, torch.zeros(b, dtype=torch.int64, device=card),
                        torch.full((b,), full, device=card),
                        torch.as_tensor(rng.integers(0, 1 << n, b),
                                        device=card),
                        torch.arange(b, device=card) % (1 << n)):
            got = ops.subset_argmin(costs, r, pen, allowed=allowed)
            want = ref.subset_argmin_ref(cost, r, pen, allowed)
            assert torch.equal(got, want), (pen.numel(), allowed)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 5, 8, 9, 12])
def test_kernel_exact_ties_at_every_lane_on_card(card, n):
    """Rows of exact ties (rho all 0, all 1, all 0.5, equal costs) at lane
    positions 0, 1, 15, 16 and 31 of a warp, in the first and a later
    warp: the lowest mask wins on the card as in the plain version."""
    rng = np.random.default_rng(850 + n)
    b = 96
    costs = np.full(n, 2.0)
    costs[n // 2:] = 1.0
    rhos = rng.uniform(0.0, 1.0, (b, n))
    for lane in (0, 1, 15, 16, 31):
        for warp, val in ((0, 0.0), (1, 1.0), (2, 0.5)):
            rhos[32 * warp + lane] = val
    r = torch.as_tensor(rhos, device=card)
    cost = ops.subset_costs(costs, n, card)
    for M in (2.0, 4.0, 100.0):
        mp = torch.as_tensor([M], dtype=torch.float64, device=card)
        for allowed in (None, torch.as_tensor(rng.integers(0, 1 << n, b),
                                              device=card)):
            got = ops.subset_argmin(costs, r, mp, allowed=allowed)
            assert torch.equal(got, ref.subset_argmin_ref(cost, r, mp,
                                                          allowed))


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


def _exhaustive_grid(dev, store=None):
    traces = {"gradle": get_trace("gradle", 6_000, seed=4)}
    base = SimConfig(n_caches=5, costs=(1.0, 2.0, 3.0, 1.5, 2.5),
                     cache_size=800, update_interval=150, alg="exhaustive")
    return run_grid(traces, base, "miss_penalty", (25.0, 100.0, 1000.0),
                    policies=("fna", "fno", "pi"), store=store, device=dev)


def _assert_grids_equal(got, want):
    assert list(got) == list(want)
    for key, cell in got.items():
        for p, res in cell.items():
            assert dataclasses.asdict(res) == \
                dataclasses.asdict(want[key][p]), (key, p)


@pytest.mark.cuda
def test_exhaustive_grid_card_equals_cpu(card):
    """A decision-side penalty grid on the card: one sweep, its stacked
    exhaustive tables through the kernel, every cell equal to the CPU's."""
    import repro_torch.cachesim.systemstate as systemstate
    ops.reset_launches()
    before = systemstate.SWEEPS_COMPUTED
    got = _exhaustive_grid(card)
    assert systemstate.SWEEPS_COMPUTED - before == 1
    assert ops.LAUNCHES["subset_argmin"] > 0
    _assert_grids_equal(got, _exhaustive_grid("cpu"))


@pytest.mark.cuda
def test_store_round_trip_on_card(card, tmp_path):
    """Cold on the card populates the store (tables keyed ``cuda``); warm
    on the card loads every table (no kernel launch, no sweep); a CPU run
    on the same store shares the sweep but builds its own tables."""
    import repro_torch.cachesim.systemstate as systemstate
    cold = _exhaustive_grid(card, ArtifactStore(tmp_path))
    warm_store = ArtifactStore(tmp_path)
    ops.reset_launches()
    before = systemstate.SWEEPS_COMPUTED
    warm = _exhaustive_grid(card, warm_store)
    assert systemstate.SWEEPS_COMPUTED == before
    assert ops.LAUNCHES["subset_argmin"] == 0
    assert warm_store.stats["table_hits"] == 6
    _assert_grids_equal(warm, cold)
    cpu_store = ArtifactStore(tmp_path)
    cpu = _exhaustive_grid("cpu", cpu_store)
    assert cpu_store.stats["sweep_hits"] == 1
    assert cpu_store.stats["table_hits"] == 0
    _assert_grids_equal(cpu, cold)


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
@pytest.mark.parametrize("side", ["at", "over"])
def test_bloom_kernel_at_the_shared_memory_limit(card, side):
    """Bitmaps that just fit one block's shared memory (staged there) and
    one byte a bitmap more (probed in device memory): the kernel equals the
    plain version on a ragged batch, and members answer 1."""
    n, k = 4, 7
    m_bytes = bloom.ops.stage_limit(card) // n + (side == "over")
    rng = np.random.default_rng(5 + (side == "over"))
    members = [torch.as_tensor(rng.integers(0, 2 ** 31, 30_000),
                               device=card) for _ in range(n)]
    bits = torch.stack([bloom.build_indicator(m, m_bytes * 8, k, seed=j)
                        for j, m in enumerate(members)])
    keys = torch.cat([torch.cat(members)[::7], torch.as_tensor(
        rng.integers(-2 ** 31, 2 ** 31, 40_001), device=card)])
    got = bloom.bloom_probe(bits, keys, k=k)
    assert torch.equal(got, bloom.bloom_probe_ref(bits, keys, k))
    for j, m in enumerate(members):
        assert bool(bloom.bloom_probe(bits, m, k=k)[:, j].all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,mbytes,b", [
    (1, 1, 1), (3, 1, 1001), (5, 3, 777), (9, 1750, 4097), (13, 17_500, 33),
    (17, 2, 65_537), (16, 17_500, 100_003)])
def test_bloom_kernel_odd_shapes_on_card(card, n, mbytes, b):
    """``m_bytes`` = 1, n not a multiple of 8 (byte stores) and a multiple
    (8-byte stores), ragged batches; random bitmaps of every fill, k from 1
    to 10, int32 and int64 keys."""
    g = torch.Generator(card).manual_seed(n * 1000 + mbytes)
    bits = torch.randint(0, 256, (n, mbytes), dtype=torch.uint8, device=card,
                         generator=g)
    bits[0] |= torch.randint(0, 256, (mbytes,), dtype=torch.uint8,
                             device=card, generator=g)
    keys = torch.randint(-2 ** 31, 2 ** 31, (b,), device=card, generator=g)
    for k in (1, 3, 10):
        for kk in (keys.to(torch.int32), keys):
            got = bloom.bloom_probe(bits, kk, k=k)
            assert torch.equal(got, bloom.bloom_probe_ref(bits, kk, k)), k


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


# ---------------------------------------------------------------------------
# LM kernels: flash attention and the SSD scan
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, hq, hkv, d, dtype, dev, sk=None):
    g = torch.Generator().manual_seed(seed)
    sk = sq if sk is None else sk
    return [torch.randn(s, generator=g).to(dtype).to(dev)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (1, 24, 24, 9, 3, 64), (2, 256, 256, 4, 2, 64), (1, 300, 300, 4, 1, 128),
    (1, 1, 1, 2, 2, 16), (2, 77, 77, 6, 3, 32), (1, 40, 75, 4, 2, 64),
    (1, 2048, 2048, 9, 3, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(card, b, sq, sk, hq, hkv, d,
                                            causal):
    """Float32 (CUDA-core kernel) at 2e-5, the JAX kernel tests' gate:
    summation order only.  bf16 (wgmma kernel) at 3e-2, and tighter: p
    stays float32 on both sides (split in two bf16 parts on the tensor
    cores), so they differ by the summation order and p's low 8 bits
    before one rounding of o to bf16 — every output within one bf16 ulp
    (at least 2^-9), at most 1% of them differing at all.  Rounding p to
    bf16 once, or dropping its low part, makes about a third differ."""
    from repro_torch.kernels import flash_attention as fa
    if causal and sq != sk:
        pytest.skip("causal masking is for prefill (Sq == Sk)")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        q, k, v = _qkv(sq + d, b, sq, hq, hkv, d, dtype, card, sk)
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.bfloat16:
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
            ulp[w == 0] = 0.0
            assert bool((diff <= torch.clamp(ulp, min=2.0 ** -9)).all()), \
                float(diff.max())
            assert int((diff > 0).sum()) <= 0.01 * diff.numel(), \
                float((diff > 0).float().mean())


@pytest.mark.cuda
def test_flash_kernel_counts_launches_and_rejects_bad_inputs(card):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(0, 1, 16, 4, 2, 64, torch.float32, card)
    fa.reset_launches()
    fa.flash_attention(q, k, v)
    fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert fa.LAUNCHES == {"flash_attention": 2}
    bad = [(q.half(), k.half(), v.half()), (q, k.bfloat16(), v),
           (q[..., :48].contiguous(), k[..., :48].contiguous(),
            v[..., :48].contiguous()),
           (q.transpose(1, 2), k, v), (q, k.cpu(), v),
           (q[:, :, :3].contiguous(), k, v)]
    for args in bad:
        with pytest.raises(ValueError):
            fa.flash_attention(*args)
    assert fa.LAUNCHES == {"flash_attention": 2}


def _ssd_inputs(seed, b, s, h, p, n, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g)
                                      - 1.0)
    A = -torch.exp(torch.rand(h, generator=g) * 2 - 1)
    B = torch.randn((b, s, n), generator=g)
    C = torch.randn((b, s, n), generator=g)
    return [x.to(dtype).to(dev), dt.to(dev), A.to(dev), B.to(dtype).to(dev),
            C.to(dtype).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 300, 32, 64, 128, 256), (2, 256, 4, 64, 64, 128),
    (1, 128, 2, 32, 16, 32), (1, 24, 3, 16, 32, 24), (2, 1, 2, 64, 128, 1),
    (1, 513, 2, 64, 128, 256), (1, 4096, 8, 64, 128, 256),
    (3, 700, 4, 64, 128, 128)])
def test_ssd_kernel_matches_plain_on_card(card, b, s, h, p, n, chunk):
    """Float32 at 2e-3 (the JAX kernel tests' gate), with and without an
    entering state; bf16 x, B, C at 3e-2 (one bf16 rounding of y).  The
    long and the batched ragged cases walk many chunks through the
    carry."""
    from repro_torch.kernels import ssd
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        args = _ssd_inputs(s + h, b, s, h, p, n, dtype, card)
        st0 = torch.randn((b, h, p, n), device=card,
                          generator=torch.Generator(card).manual_seed(1))
        for init in (None, st0):
            y, st = ssd.ssd_scan(*args, chunk=chunk, initial_state=init)
            torch.cuda.synchronize()
            y_r, st_r = ssd.ssd_scan_ref(*args, chunk=chunk,
                                         initial_state=init)
            assert y.dtype == dtype and st.dtype == torch.float32
            torch.testing.assert_close(y.float(), y_r.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(st, st_r, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_ssd_kernel_counts_launches_and_rejects_bad_inputs(card):
    from repro_torch.kernels import ssd
    args = _ssd_inputs(0, 1, 64, 2, 64, 128, torch.float32, card)
    ssd.reset_launches()
    ssd.ssd_scan(*args, chunk=32)
    assert ssd.LAUNCHES == {"ssd_scan": 1}
    x, dt, A, B, C = args
    bad = [dict(args=(x.half(), dt, A, B.half(), C.half())),
           dict(args=(x, dt.double(), A, B, C)),
           dict(args=(x[..., :48].contiguous(), dt, A, B, C)),
           dict(args=(x, dt, A, B[..., :126].contiguous(),
                      C[..., :126].contiguous())),
           dict(args=args, chunk=512),
           dict(args=(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                      B, C)),
           dict(args=(x, dt, A.cpu(), B, C))]
    for case in bad:
        with pytest.raises(ValueError):
            ssd.ssd_scan(*case["args"], chunk=case.get("chunk", 32))
    assert ssd.LAUNCHES == {"ssd_scan": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m"])
def test_reduced_serve_path_card_equals_cpu(card, arch):
    """The reduced float32 model on the card (kernels) against the CPU
    (plain versions), same weights: prefill logits and caches at 1e-4,
    greedy tokens equal, one kernel launch per layer per prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    cpu = ServeEngine(cfg, params=params, device="cpu")
    gpu = ServeEngine(cfg, device=card,
                      generator=torch.Generator().manual_seed(3))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))
    fa.reset_launches()
    ssd.reset_launches()
    lg, cache = gpu.prefill(toks, max_len=48)
    launches = fa.LAUNCHES["flash_attention"] + ssd.LAUNCHES["ssd_scan"]
    assert launches == cfg.n_layers
    lc, cache_c = cpu.prefill(toks, max_len=48)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name in cache_c:
        if name != "len":
            torch.testing.assert_close(cache[name].cpu(), cache_c[name],
                                       rtol=1e-4, atol=1e-4)
    first = np.zeros(2, np.int32)
    np.testing.assert_array_equal(gpu.decode(cache, first, 4)[0],
                                  cpu.decode(cache_c, first, 4)[0])
