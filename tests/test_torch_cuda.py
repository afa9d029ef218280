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
test states its tolerance; the bf16 SSD's tensor-core stages (each float32
operand split in two bf16 parts) keep y within 3e-3 and the final state
within 1e-4 relative L2 of the float32 scan at the three main-path
shapes.  Both kernels refuse inputs that require a
gradient, and a reduced train step (which reaches no kernel) on the card
equals the CPU's at 1e-4.  The grid layer on the card (an exhaustive
penalty grid, a store round trip) equals the CPU's field for field.  The
dry run's per-device step traced on the meta device counts the card's
kernel launches and the same FLOPs.  Two gloo ranks on the card run the
data-parallel ZeRO-1 step and the sequence-sharded decode as world 1
does, and the tensor-parallel prefill, decode and train steps of the
reduced dense and ssm configs; the bf16 row-parallel product's
float32-output GEMM and its backward equal autograd's through the same
bf16 operands.  Every ``examples/torch_*.py`` runs on the
card at a small size (the quickstart's results equal to the CPU's field
for field, the DS_PGM dead-band aside).  The ssm family's decode step as
one CUDA graph (``models.decode_graph``) gives the eager body's tokens,
its logits and caches within bf16 round-off; its prefill as one CUDA graph
(captured at a layout's second prefill) gives the eager body's logits, SSD
states and conv histories bit for bit, at mamba2-370m's published widths
and 4,090 tokens and over a stream of mixed lengths.  The published Zamba2
block (zamba2-7b-instruct): flash at head dim 224 with its (224/2)^-1/2 scale
against the plain version (the one-ulp rule) and SDPA, the SSD with 2
B/C groups against the plain version, and one period of the published
config (layers 0-6, one shared-block application) served on the card
against the benchmark's float32 reference; its decode step as one CUDA
graph, its length in a device tensor, equals the eager body bit for bit.
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
    (1, 2048, 2048, 9, 3, 64), (1, 75, 40, 4, 2, 64),
    (1, 512, 512, 32, 32, 112), (2, 77, 77, 4, 4, 112),
    (1, 48, 200, 4, 2, 112), (1, 200, 48, 4, 2, 112),
    (1, 256, 384, 16, 16, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(card, b, sq, sk, hq, hkv, d,
                                            causal):
    """Float32 (CUDA-core kernel) at 2e-5, the JAX kernel tests' gate:
    summation order only.  bf16 (wgmma kernel) at 3e-2, and tighter: p
    stays float32 on both sides (split in two bf16 parts on the tensor
    cores), so they differ by the summation order and p's low 8 bits
    before one rounding of o to bf16 — every output within one bf16 ulp
    (at least 2^-9), at most 1% of them differing at all.  Rounding p to
    bf16 once, or dropping its low part, makes about a third differ.
    Head dim 112 is zamba2-7b's shared attention (the wgmma kernel pads it
    to two 64-column panels); [1, 256 | 384, 16/16, 64] a
    seamless-m4t-medium cross attention.  Causal with Sq != Sk holds the
    reference's top-left mask (query i sees keys j <= i)."""
    from repro_torch.kernels import flash_attention as fa
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


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,groups", [
    (1, 4090, 32, 64, 128, 1), (1, 4090, 112, 64, 64, 2),
    (1, 32768, 32, 64, 128, 1)], ids=["mamba2-370m-4090",
                                      "zamba2-7b-instruct-4090",
                                      "mamba2-370m-32768"])
def test_ssd_bf16_split_keeps_float32_on_card(card, b, s, h, p, n, groups):
    """The bf16 kernel (states and output stages on the tensor cores, each
    float32 operand split in two bf16 parts) against the plain scan in
    float32 on the same bf16 inputs, chunk 256, with and without an
    entering state: y within 3e-3 relative L2 (one bf16 rounding of y is
    about 1.1e-3) and the final state within 1e-4, which a single bf16
    rounding of W, S_in or w x would break.  A bf16 call counts one
    tensor-core launch, a float32 call none."""
    from repro_torch.kernels import ssd
    x, dt, A, B, C = _ssd_inputs(s + h, b, s, h, p, groups * n,
                                 torch.bfloat16, card)
    if groups > 1:
        B = B.reshape(b, s, groups, n).contiguous()
        C = C.reshape(b, s, groups, n).contiguous()
    st0 = torch.randn((b, h, p, n), device=card,
                      generator=torch.Generator(card).manual_seed(3))
    f32 = [x.float(), dt, A, B.float(), C.float()]
    for init in (None, st0):
        mma = ssd.MMA_LAUNCHES["ssd_scan_mma"]
        y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=256, initial_state=init)
        torch.cuda.synchronize()
        assert ssd.MMA_LAUNCHES["ssd_scan_mma"] == mma + 1
        y_r, st_r = ssd.ssd_scan_ref(*f32, chunk=256, initial_state=init)
        assert y.dtype == torch.bfloat16 and y_r.dtype == torch.float32
        assert _rel_l2(y, y_r) <= 3e-3, _rel_l2(y, y_r)
        assert _rel_l2(st, st_r) <= 1e-4, _rel_l2(st, st_r)
    ssd.ssd_scan(*f32, chunk=256)
    assert ssd.MMA_LAUNCHES["ssd_scan_mma"] == mma + 1


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


def _prefill_launches(cfg) -> int:
    """Flash and SSD launches of one prefill of ``cfg``'s model."""
    if cfg.family == "hybrid":
        return cfg.n_layers + cfg.n_apps
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m",
                                  "granite-moe-3b-a800m", "internvl2-1b",
                                  "zamba2-7b", "seamless-m4t-medium",
                                  "zamba2-7b-instruct"])
def test_reduced_serve_path_card_equals_cpu(card, arch):
    """The reduced float32 model on the card (kernels) against the CPU
    (plain versions), same weights: prefill logits and caches at 1e-4,
    greedy tokens equal, one kernel launch per attention (flash) and per
    Mamba block (SSD) per prefill."""
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
    assert launches == _prefill_launches(cfg)
    lc, cache_c = cpu.prefill(toks, max_len=48)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for name in cache_c:
        if name != "len":
            torch.testing.assert_close(cache[name].cpu(), cache_c[name],
                                       rtol=1e-4, atol=1e-4)
    first = np.zeros(2, np.int32)
    np.testing.assert_array_equal(gpu.decode(cache, first, 4)[0],
                                  cpu.decode(cache_c, first, 4)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("moe_mode", ["dense", "dispatch"])
def test_moe_forward_card_equals_cpu(card, moe_mode):
    """The reduced granite-moe FFN on the card against the CPU in float32,
    both MoE modes: the same experts chosen, outputs at 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              moe_mode=moe_mode, capacity_factor=1.0)
    p = init_params(cfg, torch.Generator().manual_seed(4),
                    "cpu")["layers"][0]["moe"]
    pg = {k: v.to(card) for k, v in p.items()}
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(L.moe_route(pg, x.to(card), cfg)[1].cpu(),
                               L.moe_route(p, x, cfg)[1])
    torch.testing.assert_close(L.moe_forward(pg, x.to(card), cfg).cpu(),
                               L.moe_forward(p, x, cfg), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_kernels_refuse_grad_on_card(card):
    """Neither kernel has a backward: on the card, as on the CPU, an input
    that requires a gradient raises (its output would carry none), and
    the same call under ``torch.no_grad()`` launches the kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    g = torch.Generator(card).manual_seed(0)
    q = torch.randn(1, 64, 4, 64, device=card, generator=g)
    k = torch.randn(1, 64, 2, 64, device=card, generator=g)
    x = torch.randn(1, 64, 2, 64, device=card, generator=g)
    dt = torch.rand(1, 64, 2, device=card, generator=g) * 0.1
    A = -torch.rand(2, device=card, generator=g)
    B = torch.randn(1, 64, 16, device=card, generator=g)
    fa.reset_launches()
    ssd.reset_launches()
    for t in (q, x):
        t.requires_grad_(True)
    with pytest.raises(ValueError, match="attn_forward"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="ssd_chunked"):
        ssd.ssd_scan(x, dt, A, B, B, chunk=32)
    assert fa.LAUNCHES["flash_attention"] == ssd.LAUNCHES["ssd_scan"] == 0
    with torch.no_grad():
        fa.flash_attention(q, k, k, causal=True)
        ssd.ssd_scan(x, dt, A, B, B, chunk=32)
    assert fa.LAUNCHES["flash_attention"] == ssd.LAUNCHES["ssd_scan"] == 1


@pytest.mark.cuda
def test_reduced_train_step_card_equals_cpu(card):
    """One ``make_train_step`` of the reduced smollm-135m (float32) on the
    card and on the CPU from the same weights: loss, grad_norm and every
    gradient at 1e-4; no kernel launched.  (The updated parameters are
    not compared: AdamW's first step moves each by lr * sign(g), and
    where a gradient is ~0 rounding decides its sign.)"""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import (OptConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("smollm-135m").reduced()
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    host = SyntheticLMData(DataConfig(batch=2, seq=32), cfg).batch_at(0)
    ocfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    fa.reset_launches()
    ssd.reset_launches()
    out = []
    for dev in ("cpu", card):
        batch = to_device(host, dev)
        p = tree_map(lambda t: t.to(dev), params)
        (loss, _), grads = loss_and_grads(model, p, batch)
        _, metrics = make_train_step(model, ocfg)(init_train_state(p, ocfg),
                                                  batch)
        out.append((loss, metrics["grad_norm"], grads))
    assert fa.LAUNCHES["flash_attention"] == ssd.LAUNCHES["ssd_scan"] == 0
    for want, got in zip(out[0][:2], out[1][:2]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for want, got in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_world_one_nccl_mesh_train_step_equals_plain(card):
    """One train step of the reduced smollm-135m on a (1, 1) elastic mesh
    over a world of one rank on NCCL (parameters, m and v DTensors) equals
    the plain step on the card: loss, grad_norm and every updated
    parameter at 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.ft import elastic_mesh
    from repro_torch.launch.mesh import init_distributed, shutdown_distributed
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import OptConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config("smollm-135m").reduced()
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(card).manual_seed(1), card)
    batch = to_device(SyntheticLMData(DataConfig(batch=2, seq=32),
                                      cfg).batch_at(0), card)
    ocfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(model, ocfg)
    plain, want = step(init_train_state(params, ocfg), batch)
    init_distributed(card, "nccl")
    try:
        mesh = elastic_mesh(model_dim=1)
        dp = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params, cfg.tie_embeddings))
        new, got = step(init_train_state(dp, ocfg), batch)
        new = sh.unshard(new["params"])
    finally:
        shutdown_distributed()
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(plain["params"]), tree_leaves(new)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "zamba2-7b"])
def test_dryrun_trace_equals_card(card, arch, kind):
    """The dry run's per-device step of a reduced config traced on the
    meta device and run on the card under the same cost trace: the card's
    kernel launches equal the trace's kernel calls exactly, and both count
    the same FLOPs and operations."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch import dryrun
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("small", 64, 2, kind)
    meta = dryrun.run_traced(*dryrun.build_step(cfg, shape, None,
                                                torch.device("meta")))
    fa.reset_launches()
    ssd.reset_launches()
    got = dryrun.run_traced(*dryrun.build_step(cfg, shape, None, card))
    torch.cuda.synchronize()
    total = {k: v for k, v in {**fa.LAUNCHES, **ssd.LAUNCHES}.items() if v}
    launches = got["card"]["launches"]
    assert launches == meta["kernel_calls"] == got["kernel_calls"]
    # the traced step and the timed one
    assert total == {k: 2 * v for k, v in launches.items()}
    assert got["flops"] == meta["flops"] and got["ops"] == meta["ops"]
    assert (kind == "prefill") == bool(launches)


def _data_axes_inputs(card):
    """The reduced smollm-135m, its weights, a train batch whose rows keep
    32 - 3 r tokens (unequal data shards) and a decode cache after an
    11-token prefill (32 positions), all on ``card``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.models import get_model, init_params
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, torch.Generator(card).manual_seed(1), card)
    batch = to_device(SyntheticLMData(DataConfig(batch=8, seq=32),
                                      cfg).batch_at(0), card)
    keep = 32 - 3 * torch.arange(8, device=card)[:, None]
    batch["mask"] = (torch.arange(32, device=card)[None] < keep).float()
    prompt = torch.randint(0, cfg.vocab, (2, 11), device=card,
                           generator=torch.Generator(card).manual_seed(2))
    return cfg, params, batch, prompt


def _data_axes_card(card, mesh_dp=None, mesh_seq=None):
    """Two ZeRO-1 steps (the batch cut over ``mesh_dp``'s data axis) and
    eight decode steps (the KV sequence cut over ``mesh_seq``) of the
    reduced smollm-135m, dense and int8-KV; world 1 when the meshes are
    None: (losses, full parameters, {case: logits})."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, init_train_state, make_train_step
    cfg, params, batch, prompt = _data_axes_inputs(card)
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(params, ocfg)
    if mesh_dp is not None:
        state = S.lay_out(state, mesh_dp, S.state_shardings(mesh_dp, cfg,
                                                            state))
        batch = S.lay_out(batch, mesh_dp, S.batch_shardings(mesh_dp, cfg,
                                                            batch))
    step = make_train_step(get_model(cfg), ocfg)
    losses = []
    for _ in range(2):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    logits = {}
    for kvq in (False, True):
        dcfg = dataclasses.replace(cfg, kv_quant=kvq)
        model = get_model(dcfg)
        _, cache = model.prefill(params, {"tokens": prompt}, 32)
        shape = ShapeConfig("t", 32, 2, "decode")
        if mesh_seq is not None:
            cache = S.lay_out(cache, mesh_seq, S.cache_shardings(
                mesh_seq, dcfg, cache, shape))
        out = []
        for i in range(8):
            tok = prompt[:, i]
            if mesh_seq is not None:
                tok = S.lay_out(tok, mesh_seq, S.token_shardings(mesh_seq,
                                                                 shape))
            lg, cache = model.decode_step(params, cache, tok)
            out.append(sh.full(lg).cpu())
        logits["kvq" if kvq else "dense"] = torch.stack(out)
    return losses, sh.unshard(state["params"]), logits


def _data_axes_world(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_map
    card = torch.device("cuda", 0)
    losses, params, logits = _data_axes_card(
        card, make_mesh((2, 1), ("data", "model")),
        make_mesh((1, 2), ("data", "model")))
    if rank == 0:
        torch.save((losses, tree_map(lambda t: t.cpu(), params), logits),
                   f"{out_dir}/data_axes.pt")


@pytest.mark.cuda
def test_data_axes_two_ranks_on_card_equal_world_one(card, tmp_path):
    """Two gloo ranks on the card: the reduced smollm-135m step with a
    ZeRO-1 state on (2, 1) and a batch cut over data (unequal masks), and
    the decode with the KV sequence cut over (1, 2), dense and int8-KV,
    against world 1 on the card: losses at 1e-4 relative, parameters at
    2e-4, float32 logits at 1e-5 of the largest (int8-KV 1e-3)."""
    from repro_torch.launch.mesh import run_world
    from repro_torch.tree import tree_leaves
    run_world(_data_axes_world, 2, tmp_path / "store",
              args=(str(tmp_path),), device="cuda", backend="gloo",
              timeout=300)
    losses, params, logits = torch.load(tmp_path / "data_axes.pt")
    w_losses, w_params, w_logits = _data_axes_card(card)
    np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
    for a, b in zip(tree_leaves(w_params), tree_leaves(params)):
        torch.testing.assert_close(b, a.cpu(), rtol=2e-4, atol=2e-4)
    for case, tol in (("dense", 1e-5), ("kvq", 1e-3)):
        want = w_logits[case]
        torch.testing.assert_close(logits[case], want, rtol=0,
                                   atol=tol * float(want.abs().max()))


def _tp_serve(card, arch, mesh=None):
    """Prefill (12 tokens, batch 2) and four decode steps of ``arch``'s
    reduced config on ``card``, weights drawn from seed 3: on ``mesh``
    with the parameters laid out by ``param_shardings`` (tensor-parallel
    blocks), the cache by ``cache_shardings``; world 1 when None.
    Returns (prefill logits, every step's logits) on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(card).manual_seed(3), card)
    g = torch.Generator(card).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (2, 12), device=card, generator=g)
    toks = torch.randint(0, cfg.vocab, (4, 2), device=card, generator=g)
    shape = ShapeConfig("t", 32, 2, "decode")
    rules = None
    if mesh is not None:
        params = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params, cfg.tie_embeddings))
        rules = S.make_rules(mesh, cfg)
    with sh.activation_rules(rules):
        kw = {} if cfg.family == "ssm" else {"max_len": 32}
        lg, cache = model.prefill(params, {"tokens": prompt}, **kw)
        if mesh is not None:
            cache = S.lay_out(cache, mesh, S.cache_shardings(mesh, cfg,
                                                             cache, shape))
        out = []
        for tok in toks:
            if mesh is not None:
                tok = S.lay_out(tok, mesh, S.token_shardings(mesh, shape))
            step, cache = model.decode_step(params, cache, tok)
            out.append(sh.full(step).cpu())
    return lg.cpu(), torch.stack(out)


def _tp_world(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh
    card = torch.device("cuda", 0)
    mesh = make_mesh((1, 2), ("data", "model"))
    res = {arch: _tp_serve(card, arch, mesh)
           for arch in ("smollm-135m", "mamba2-370m")}
    if rank == 0:
        torch.save(res, f"{out_dir}/tp.pt")


@pytest.mark.cuda
def test_tp_serving_two_ranks_on_card_equal_world_one(card, tmp_path):
    """Two gloo ranks on the card, (1, 2): the reduced smollm-135m and
    mamba2-370m prefill and decode with tensor-parallel blocks (column-
    and row-parallel products, the vocab-parallel embedding and head, the
    SSM heads on ``model``, sequence parallelism under the rules) against
    world 1 on the card: float32 logits within 1e-5 of the largest,
    argmax equal."""
    from repro_torch.launch.mesh import run_world
    run_world(_tp_world, 2, tmp_path / "store", args=(str(tmp_path),),
              device="cuda", backend="gloo", timeout=300)
    res = torch.load(tmp_path / "tp.pt")
    for arch, got in res.items():
        for a, w in zip(got, _tp_serve(card, arch)):
            torch.testing.assert_close(a, w, rtol=0,
                                       atol=1e-5 * float(w.abs().max()))
            assert torch.equal(a.argmax(-1), w.argmax(-1)), arch


def _tp_train(card, arch, mesh=None):
    """Two AdamW steps of the reduced ``arch`` on the card from seed 9's
    weights, tensor-parallel on ``mesh`` under its rules (world 1 when
    None): the losses and the full final parameters."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import OptConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    params = {k: v for k, v in _to_card(params, card).items()}
    g = torch.Generator().manual_seed(10)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=g).to(card)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    ocfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(params, ocfg)
    rules = None
    if mesh is not None:
        state = S.lay_out(state, mesh, S.state_shardings(mesh, cfg, state))
        rules = S.make_rules(mesh, cfg)
    step = make_train_step(get_model(cfg), ocfg)
    losses = []
    with sh.activation_rules(rules):
        for _ in range(2):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
    return losses, [p.cpu() for p in tree_leaves(sh.unshard(state["params"]))]


def _to_card(tree, card):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(card), tree)


def _tp_train_world(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh
    card = torch.device("cuda", 0)
    mesh = make_mesh((1, 2), ("data", "model"))
    res = {arch: _tp_train(card, arch, mesh)
           for arch in ("smollm-135m", "mamba2-370m")}
    if rank == 0:
        torch.save(res, f"{out_dir}/tp_train.pt")


@pytest.mark.cuda
def test_tp_training_two_ranks_on_card_equal_world_one(card, tmp_path):
    """Two gloo ranks on the card, (1, 2) under its rules: two AdamW steps
    of the reduced smollm-135m and mamba2-370m with tensor-parallel,
    sequence-parallel blocks and the vocab-parallel cross-entropy, against
    world 1 on the card: losses within 1e-4 relative, parameters within
    2e-4 (the mesh's gates)."""
    from repro_torch.launch.mesh import run_world
    run_world(_tp_train_world, 2, tmp_path / "store", args=(str(tmp_path),),
              device="cuda", backend="gloo", timeout=300)
    res = torch.load(tmp_path / "tp_train.pt")
    for arch, (losses, params) in res.items():
        want_losses, want = _tp_train(card, arch)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
        for a, w in zip(params, want):
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


def _rms_tol(want):
    """bf16's relative tolerance, and an absolute one of 1e-3 of ``want``'s
    root mean square for the entries that cancel towards zero."""
    return dict(rtol=1.6e-2,
                atol=1e-3 * float(want.double().pow(2).mean().sqrt()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [288, 768])
def test_partial_bf16_backward_equals_autograd(card, k):
    """``tp._partial`` of bf16 operands on the card — one GEMM with a
    float32 output, its backward ``tp._PartialMM`` — at smollm-135m's
    row-parallel products on two ranks (attention's ``wo``, k = 288; the
    MLP's, k = 768): the output within float32 rounding of the exact
    product, and ``dh`` and ``dw`` bf16 and within bf16 rounding both of
    autograd's through ``h @ w`` of the same bf16 operands and of the
    float64 products of the bf16 gradient."""
    from repro_torch.distributed import tp
    g = torch.Generator().manual_seed(k)
    h0 = torch.randn(2, 128, k, generator=g).to(card, torch.bfloat16)
    w0 = (torch.randn(k, 576, generator=g) / k ** 0.5).to(card,
                                                          torch.bfloat16)
    c = torch.randn(2, 128, 576, generator=g).to(card)
    h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = tp._partial(h, w)
    assert y.dtype == torch.float32
    assert type(y.grad_fn).__name__ == "_PartialMMBackward"
    (y * c).sum().backward()
    hr, wr = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    ((hr @ wr).float() * c).sum().backward()
    exact = h0.double() @ w0.double()
    torch.testing.assert_close(y.double(), exact, rtol=1e-5,
                               atol=1e-5 * float(exact.abs().max()))
    gb = c.to(torch.bfloat16).double().reshape(-1, 576)
    truth = {"dh": (gb @ w0.double().T).reshape(h0.shape),
             "dw": h0.double().reshape(-1, k).T @ gb}
    for name, got, want in (("dh", h.grad, hr.grad), ("dw", w.grad, wr.grad)):
        assert got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got, want, **_rms_tol(want), msg=name)
        torch.testing.assert_close(got.double(), truth[name],
                                   **_rms_tol(truth[name]), msg=name)


# ---------------------------------------------------------------------------
# the examples on the card (ROADMAP C-gap-2)
# ---------------------------------------------------------------------------

def _example(name: str):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ds_pgm_gaps(costs, rhos, M, allowed=None):
    """The relative gap between the two best DS_PGM prefix costs of each
    row of exclusion probabilities ``rhos`` [R, n] (host NumPy; the FNO
    tables choose among the ``allowed`` caches)."""
    r = np.clip(rhos, 1e-12, 1.0 - 1e-12)
    key = costs[None, :] / -np.log(r)
    c_b = np.broadcast_to(costs, r.shape)
    if allowed is not None:
        key = np.where(allowed, key, np.inf)
        c_b = np.where(allowed, c_b, np.inf)
        r = np.where(allowed, r, 1.0)
    order = np.argsort(key, axis=1, kind="stable")
    csum = np.cumsum(np.take_along_axis(c_b, order, 1), axis=1)
    lprod = np.cumsum(np.log(np.take_along_axis(r, order, 1)), axis=1)
    phi = np.concatenate([np.full((r.shape[0], 1), M),
                          csum + M * np.exp(lprod)], axis=1)
    two = np.sort(phi, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.maximum(np.abs(two[:, 0]), 1.0)


@pytest.mark.cuda
def test_example_quickstart_card_equals_cpu(card):
    """``examples/torch_quickstart.py`` on the card and on the CPU: every
    policy's ``SimResult`` field for field.  A DS_PGM table of the run
    may differ between the two only inside the 1e-12 dead-band (rows
    whose two best prefix costs nearly tie); the policy that reads such a
    table (``fna`` the FNA one, ``fno`` the CS_FNO one) is then left out,
    while ``pi`` (no table) and ``fna_cal`` (its tables built on the
    host) are compared always."""
    from repro_torch.cachesim import RunReport
    from repro_torch.core.batched import selection_tables
    n = 6000
    got = _example("torch_quickstart").main(["--requests", str(n)])
    want = _example("torch_quickstart").main(["--device", "cpu",
                                              "--requests", str(n)])
    cfg = SimConfig(n_caches=3, cache_size=2_000, costs=(1.0, 2.0, 3.0),
                    miss_penalty=100.0, bpe=14.0, update_interval=512)
    rep = RunReport()
    run_policies(get_trace("gradle", n, seed=0), cfg, ("pi",), device=card,
                 report=rep)
    st = rep.system
    d = st.device_arrays()
    costs, n = np.asarray(cfg.costs, np.float64), cfg.n_caches
    bits = ((np.arange(1 << n)[:, None] >> np.arange(n)[None, :]) & 1) > 0
    rhos = np.where(bits[None], st.pi_v[:, None, :],
                    st.nu_v[:, None, :]).reshape(-1, n)
    differ = {}
    for fno in (False, True):
        on_card = selection_tables(costs, d["pi"], d["nu"], cfg.miss_penalty,
                                   fno=fno).cpu().numpy().reshape(-1, n)
        on_cpu = selection_tables(costs, torch.as_tensor(st.pi_v),
                                  torch.as_tensor(st.nu_v), cfg.miss_penalty,
                                  fno=fno).numpy().reshape(-1, n)
        rows = np.flatnonzero((on_card != on_cpu).any(axis=1))
        differ[fno] = rows.size > 0
        if rows.size:           # a differing row: a near-tie of the two best
            allowed = np.tile(bits, (len(st.pi_v), 1))[rows] if fno else None
            gaps = _ds_pgm_gaps(costs, rhos[rows], cfg.miss_penalty, allowed)
            assert (gaps <= 1e-12).all(), (fno, gaps.max())
    assert set(got) == set(want)
    reads = {"fna": False, "fno": True}     # the DS_PGM table a policy reads
    compared = [p for p in want if p not in reads or not differ[reads[p]]]
    assert {"pi", "fna_cal"} <= set(compared), compared
    for p in compared:
        assert dataclasses.asdict(got[p]) == dataclasses.asdict(want[p]), p


@pytest.mark.cuda
def test_example_scenario_sweep_on_card(card):
    cells_ = _example("torch_scenario_sweep").main(["hetero_tiers", "3000"])
    assert cells_ and all("pi" in c["cost"] for c in cells_)


@pytest.mark.cuda
def test_example_serve_prefix_cache_on_card(card):
    out = _example("torch_serve_prefix_cache").main(["--requests", "12"])
    assert set(out) == {"fno", "fna", "fna_cal", "pi"}
    assert all(st.requests == 12 and st.prefills >= 1
               for st in out.values())


@pytest.mark.cuda
def test_example_train_lm_on_card(card):
    assert _example("torch_train_lm").main(["--steps", "3"]) == 0


@pytest.mark.cuda
def test_example_elastic_restart_on_card_is_bit_exact(card):
    loss = _example("torch_elastic_restart").main(["--steps", "6",
                                                   "--kill-at", "3"])
    assert np.isfinite(loss)


#: the five stage kernels of one ``kernels.ssd`` call
SSD_STAGES = ("ssd_cumsum_kernel", "ssd_cb_kernel", "ssd_states_kernel",
              "ssd_carry_kernel", "ssd_out_kernel")


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_card(card):
    """With the card's activity traced, a program span and a
    ``record_function`` around the same code start within 1 ms of each
    other: the spans lie on the device trace's timeline as recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing
    x = torch.ones(1 << 16, device=card)
    tracing.clear()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                with tracing.span("clock"), record_function("clock.rf"):
                    x.sum()
            torch.cuda.synchronize(card)
    finally:
        tracing.disable()
    mine = [s.start_ns for s in tracing.spans()]
    tracing.clear()
    theirs = sorted(ev.start_ns() for ev in prof.profiler.kineto_results
                    .events() if ev.name() == "clock.rf" and
                    ev.device_type() == DeviceType.CPU)
    assert len(mine) == len(theirs) == 3
    assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000


@pytest.mark.cuda
def test_prefill_span_holds_every_ssd_stage_launch_on_card(card):
    """Every SSD stage kernel of a mamba2-370m prefill traced on the card
    belongs to that prefill's span: each has a launch record (the runtime
    call with the kernel's correlation id; the ctypes-loaded library's
    launches are traced like torch's own), and it lies inside the span,
    which ends when the launches are enqueued.  A layout's first prefill
    runs the eager body, so each kernel's record is its own launch
    (``cudaLaunch*`` / ``cuLaunch*``); its third replays the graph its
    second captured, so each kernel's record is that prefill's graph
    launch (``cudaGraphLaunch`` / ``cuGraphLaunch``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeEngine
    cfg = get_config("mamba2-370m").reduced()
    engine = ServeEngine(cfg, device=card,
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    # builds and loads the kernels, on a layout of its own
    engine.prefill(rng.integers(0, cfg.vocab, (1, 48)), max_len=66)
    toks = rng.integers(0, cfg.vocab, (1, 64))

    def traced():
        torch.cuda.synchronize(card)
        tracing.clear()
        tracing.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                engine.prefill(toks, max_len=66)
                torch.cuda.synchronize(card)
        finally:
            tracing.disable()
        (span,) = tracing.spans()
        tracing.clear()
        return span, list(prof.profiler.kineto_results.events())

    eager = traced()
    engine.prefill(toks, max_len=66)           # captures the graph
    replayed = traced()
    # the launch calls of the CUDA runtime (cudaLaunch*, cudaGraphLaunch)
    # and of its lower-level API (cuLaunch*, cuGraphLaunch): their
    # correlation ids are CUPTI's, a host operator's id is another count
    for (span, events), kind in ((eager, ("cudaLaunch", "cuLaunch")),
                                 (replayed, ("cudaGraphLaunch",
                                             "cuGraphLaunch"))):
        assert span.name == "prefill"
        launches = {ev.correlation_id(): ev.start_ns() for ev in events
                    if ev.device_type() == DeviceType.CPU and
                    ev.name().startswith(kind)}
        stages = [ev for ev in events
                  if ev.device_type() != DeviceType.CPU and
                  any(st in ev.name() for st in SSD_STAGES)]
        assert len(stages) == len(SSD_STAGES) * cfg.n_layers
        for ev in stages:
            launched = launches.get(ev.correlation_id())
            assert launched is not None, (kind, ev.name())
            assert span.start_ns <= launched <= span.end_ns, ev.name()


def _graph_model(card, seed=3, n_layers=3):
    """mamba2-370m at its published widths (and vocabulary), cut to
    ``n_layers`` blocks, weights drawn on the card from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=n_layers)
    params = init_params(cfg, torch.Generator(card).manual_seed(seed), card)
    return cfg, get_model(cfg), params


def _bf16_close(got, want):
    """Within four bf16 steps of the largest value: the graph and the eager
    body run the same operations in the same types, and the only latitude
    is a GEMM's algorithm, which cuBLAS may pick otherwise on the capture
    stream; each such product rounds its bf16 output once."""
    torch.testing.assert_close(got, want, rtol=0,
                               atol=4 * 2.0 ** -8 * float(want.abs().max()))


@pytest.mark.cuda
def test_decode_graph_equals_the_eager_body_on_card(card):
    """Greedy decode of 8 tokens from two prefix caches in a row (a stale
    static buffer would show in the second): the graph's tokens equal the
    eager body's, its logits and the caller's cache after every step lie
    within bf16 round-off of eager's, and each step returns logits of its
    own.  Counters: one capture, then replays, over both caches (one
    layout)."""
    from repro_torch import tracing
    cfg, model, params = _graph_model(card)
    g = torch.Generator(card).manual_seed(5)
    tracing.reset_counters()
    with torch.no_grad():
        for doc in range(2):
            prompt = torch.randint(0, cfg.vocab, (1, 64 + 32 * doc),
                                   device=card, generator=g)
            _, cache = model.prefill(params, {"tokens": prompt})
            mine = {k: v.clone() for k, v in cache.items()}
            tok = mine_tok = torch.zeros(1, dtype=torch.int64, device=card)
            kept = []
            for _ in range(8):
                got, out = model.decode_step(params, cache, tok)
                want, mine = model._decode_eager(params, mine, mine_tok)
                assert out is cache and got.dtype == torch.float32
                _bf16_close(got, want)
                for name in cache:
                    _bf16_close(cache[name].float(), mine[name].float())
                tok, mine_tok = got.argmax(-1), want.argmax(-1)
                assert torch.equal(tok, mine_tok)
                kept.append((got, got.clone()))
            assert len({lg.data_ptr() for lg, _ in kept}) == len(kept)
            for lg, copy in kept:
                assert torch.equal(lg, copy)
    decode = {k: v for k, v in tracing.counters().items()
              if k.startswith("decode.")}
    assert decode == {"decode.graph_captures": 1,
                      "decode.graph_replays": 15}


@pytest.mark.cuda
def test_decode_graph_through_serve_engine_on_card(card):
    """``ServeEngine.decode`` replays the graph and leaves its input cache
    as it was; weights updated in place are read by the next replay; a new
    ``params`` object recaptures; another layout (batch 2) takes a graph of
    its own and a third drops the least recently used."""
    from repro_torch import tracing
    from repro_torch.serving import ServeEngine
    cfg, _, params = _graph_model(card)
    eng = ServeEngine(cfg, params=params, device=card)
    model = eng.model
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 48))
    _, cache = eng.prefill(toks, max_len=64)
    before = {k: v.clone() for k, v in cache.items()}
    tracing.reset_counters()
    first = np.zeros(1, np.int32)
    out, _ = eng.decode(cache, first, 4)
    for name in cache:
        assert torch.equal(cache[name], before[name])
    assert tracing.counters() == {"decode.graph_captures": 1,
                                  "decode.graph_replays": 3}
    with torch.no_grad():
        want = []
        mine = {k: v.clone() for k, v in cache.items()}
        tok = torch.zeros(1, dtype=torch.int64, device=card)
        for _ in range(4):
            lg, mine = model._decode_eager(params, mine, tok)
            tok = lg.argmax(-1)
            want.append(int(tok))
    assert out[0].tolist() == want

    def step_vs_eager(p, c):
        with torch.no_grad():
            tok = torch.full((c["state"].shape[1],), 11, dtype=torch.int64,
                             device=card)
            mine = {k: v.clone() for k, v in c.items()}
            got, _ = model.decode_step(p, {k: v.clone() for k, v in
                                           c.items()}, tok)
            want, _ = model._decode_eager(p, mine, tok)
        _bf16_close(got, want)
        return got

    with torch.no_grad():
        params["final_norm"].add_(0.25)          # in place: the same graph
    step_vs_eager(params, cache)
    assert tracing.counters()["decode.graph_captures"] == 1
    _, _, other = _graph_model(card, seed=4)
    a, b = step_vs_eager(params, cache), step_vs_eager(other, cache)
    assert not torch.allclose(a, b)
    assert tracing.counters()["decode.graph_captures"] == 2
    two = {k: torch.cat([v, v], dim=1) for k, v in cache.items()}
    step_vs_eager(other, two)
    assert len(model._graphs._graphs) == 2
    three = {k: torch.cat([v, v, v], dim=1) for k, v in cache.items()}
    step_vs_eager(other, three)
    assert len(model._graphs._graphs) == 2
    assert tracing.counters()["decode.graph_captures"] == 4
    assert "decode.eager_steps" not in tracing.counters()


@pytest.mark.cuda
def test_decode_graph_stays_off_with_grad_or_a_dispatch_mode_on_card(card):
    """Autograd on, or a Python dispatch mode active (the dry run's cost
    trace), runs the eager body: counted as eager steps on the card, and
    the cost trace sees every operation."""
    from repro_torch import tracing
    from repro_torch.launch.cost import CostTrace
    cfg, model, params = _graph_model(card, n_layers=2)
    cache = model.init_cache(1, device=card)
    tok = torch.zeros(1, dtype=torch.int64, device=card)
    tracing.reset_counters()
    model.decode_step(params, cache, tok)
    with torch.no_grad(), CostTrace() as tr:
        model.decode_step(params, cache, tok)
    assert tr.ops > 100 and tr.flops > 0
    assert tracing.counters() == {"decode.eager_steps": 2}


def _prefill_model(card, reduced):
    """mamba2-370m whole and as published (bf16 compute) with 4,090-token
    prompts, or its reduced float32 config with [2, 100] prompts; weights
    drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    cfg = get_config("mamba2-370m")
    cfg, shape = (cfg.reduced(), (2, 100)) if reduced else (cfg, (1, 4090))
    params = init_params(cfg, torch.Generator(card).manual_seed(7), card)
    return cfg, get_model(cfg), params, shape


@pytest.mark.cuda
@pytest.mark.parametrize("reduced", [False, True],
                         ids=["published-bf16-4090", "reduced-float32"])
def test_prefill_graph_equals_the_eager_body_on_card(card, reduced):
    """Four prefills of other tokens through ``prefill`` (the first runs
    the eager body, the second captures, the others replay) and through
    the eager body: logits, ``state`` and ``conv`` bit-equal; each call's
    outputs are tensors of its own, left as they were by the later
    replays.  Counters: one eager run, one capture, two replays, no decode
    counter; the SSD's launch counter rises by one launch a block for
    each prefill, eager, captured or replayed, and in bf16 its tensor-core
    counter with it."""
    from repro_torch import tracing
    from repro_torch.kernels import ssd
    cfg, model, params, shape = _prefill_model(card, reduced)
    g = torch.Generator(card).manual_seed(5)
    tracing.reset_counters()
    kept = []
    with torch.no_grad():
        for _ in range(4):
            batch = {"tokens": torch.randint(0, cfg.vocab, shape,
                                             device=card, generator=g)}
            n = ssd.LAUNCHES["ssd_scan"]
            mma = ssd.MMA_LAUNCHES["ssd_scan_mma"]
            got, cache = model.prefill(params, batch)
            assert ssd.LAUNCHES["ssd_scan"] - n == cfg.n_layers
            # bf16 calls run the tensor-core stages, float32 calls do not
            assert ssd.MMA_LAUNCHES["ssd_scan_mma"] - mma == (
                0 if reduced else cfg.n_layers)
            want, mine = model._prefill_eager(params, batch)
            assert torch.equal(got, want)
            assert set(cache) == set(mine) == {"state", "conv"}
            for name in mine:
                assert cache[name].dtype == mine[name].dtype
                assert torch.equal(cache[name], mine[name]), name
            kept.append(((got, cache), (want, mine)))
    assert len({lg.data_ptr() for (lg, _), _ in kept}) == 4
    for (got, cache), (want, mine) in kept:
        assert torch.equal(got, want)
        for name in mine:
            assert torch.equal(cache[name], mine[name])
    assert tracing.counters() == {"prefill.eager_runs": 1,
                                  "prefill.graph_captures": 1,
                                  "prefill.graph_replays": 2}


@pytest.mark.cuda
def test_prefill_graphs_of_a_mixed_length_stream_on_card(card):
    """Prompt lengths in rotation, three recurring and two seen once,
    through ``prefill`` on the card: each equal bit for bit to the eager
    body; the first two lengths to recur are captured once each and
    replayed, every other prefill runs the eager body, and no graph is
    evicted or captured again."""
    from repro_torch import tracing
    cfg, model, params, _ = _prefill_model(card, True)
    g = torch.Generator(card).manual_seed(6)
    stream = [100, 60, 100, 140, 60, 100, 140, 33, 60, 140, 71, 100, 140]
    tracing.reset_counters()
    with torch.no_grad():
        for s in stream:
            batch = {"tokens": torch.randint(0, cfg.vocab, (2, s),
                                             device=card, generator=g)}
            got, cache = model.prefill(params, batch)
            want, mine = model._prefill_eager(params, batch)
            assert torch.equal(got, want), s
            for name in mine:
                assert torch.equal(cache[name], mine[name]), (s, name)
    assert tracing.counters() == {"prefill.eager_runs": 8,
                                  "prefill.graph_captures": 2,
                                  "prefill.graph_replays": 3}
    assert sorted(key[2][1][1] for key in model._prefill_graphs._graphs) \
        == [60, 100]


@pytest.mark.cuda
def test_prefill_graph_stays_off_with_grad_or_a_dispatch_mode_on_card(card):
    """Autograd on, or a Python dispatch mode active (the dry run's cost
    trace), runs the eager prefill: counted as eager runs on the card, the
    cost trace sees every operation, and no graph is kept."""
    from repro_torch import tracing
    from repro_torch.launch.cost import CostTrace
    cfg, model, params, shape = _prefill_model(card, True)
    batch = {"tokens": torch.zeros(shape, dtype=torch.int64, device=card)}
    tracing.reset_counters()
    want, _ = model.prefill(params, batch)
    with torch.no_grad(), CostTrace() as tr:
        got, _ = model.prefill(params, batch)
    assert tr.ops > 100 and tr.flops > 0
    assert torch.equal(got, want)
    assert tracing.counters() == {"prefill.eager_runs": 2}
    assert not model._prefill_graphs._graphs


def _one_ulp(got, want):
    """bf16 outputs within one bf16 ulp of the float32-p plain version
    (at least 2^-9), at most 1% differing at all (the rule of
    ``test_flash_kernel_matches_plain_on_card``)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    ulp[w == 0] = 0.0
    assert bool((diff <= torch.clamp(ulp, min=2.0 ** -9)).all()), \
        float(diff.max())
    assert int((diff > 0).sum()) <= 0.01 * diff.numel(), \
        float((diff > 0).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv", [
    (1, 4090, 4090, 32, 32), (2, 77, 77, 4, 4), (1, 48, 200, 4, 2),
    (1, 200, 48, 4, 2), (1, 1, 1, 2, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_head_dim_224_on_card(card, b, sq, sk, hq, hkv,
                                              causal):
    """Head dim 224 (zamba2-7b-instruct's shared attention; the wgmma
    kernel pads a fourth 64-column panel) at the published scale
    (224/2)^-1/2: float32 at 2e-5 and bf16 by the one-ulp rule against the
    plain version, and both within 3e-2 of SDPA (float32 math on the same
    inputs) at that scale."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    d, scale = 224, 112 ** -0.5
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        q, k, v = _qkv(sq + 5, b, sq, hq, hkv, d, dtype, card, sk)
        got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.bfloat16:
            _one_ulp(got, want)
        if sq != sk and causal:
            continue            # SDPA's causal mask is bottom-right there
        rep = hq // hkv
        sdpa = F.scaled_dot_product_attention(
            q.float().transpose(1, 2),
            k.float().repeat_interleave(rep, 2).transpose(1, 2),
            v.float().repeat_interleave(rep, 2).transpose(1, 2),
            is_causal=causal, scale=scale).transpose(1, 2)
        torch.testing.assert_close(got.float(), sdpa, rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 4090, 112, 64, 64, 256), (2, 300, 8, 64, 64, 128),
    (1, 24, 4, 16, 32, 24), (3, 513, 4, 32, 128, 256)])
def test_ssd_kernel_with_two_groups_on_card(card, b, s, h, p, n, chunk):
    """B/C in 2 groups ([b, s, 2, n]; head h reads group h // (h/2)):
    float32 at 2e-3, bf16 at 3e-2 against the plain version, with and
    without an entering state, as the one-group test."""
    from repro_torch.kernels import ssd
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        x, dt, A, B, C = _ssd_inputs(s + h, b, s, h, p, 2 * n, dtype, card)
        B = B.reshape(b, s, 2, n).contiguous()
        C = C.reshape(b, s, 2, n).contiguous()
        st0 = torch.randn((b, h, p, n), device=card,
                          generator=torch.Generator(card).manual_seed(2))
        for init in (None, st0):
            y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                 initial_state=init)
            torch.cuda.synchronize()
            y_r, st_r = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                         initial_state=init)
            torch.testing.assert_close(y.float(), y_r.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(st, st_r, rtol=2e-3, atol=2e-3)


def _bench_reference(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "bench" / "reference" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location("card_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _published_period(card, dtype):
    """zamba2-7b-instruct at every published width, cut to one period of
    its layout (layers 0-6, the shared block applied before layer 6)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"), n_layers=7,
                              hybrid_layer_ids=(6,), dtype=dtype)
    params = init_params(cfg, torch.Generator(card).manual_seed(4), card)
    return cfg, get_model(cfg), params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 0.1)])
def test_published_zamba2_period_served_on_card(card, dtype, tol):
    """zamba2-7b-instruct at every published width, cut to one period of
    its layout (layers 0-6, the shared block applied before layer 6),
    served through ``ServeEngine`` on the card (the SSD kernel with 2
    groups, flash at head dim 224): the prefill's last logits and 3 decode
    steps' logits through the cache against the benchmark's float32
    reference's full forward, relative L2.  Float32 compute at 2e-3 (the
    kernels' summation orders); bf16 (the configuration's) at 0.1.  The
    decode steps, autograd off, go through the decode graph: one capture
    and two replays, no eager step."""
    from bench.reference import blocks
    from repro_torch import tracing
    from repro_torch.serving import ServeEngine
    cfg, _, params = _published_period(card, dtype)
    engine = ServeEngine(cfg, params=params, device=card)
    toks = torch.randint(0, cfg.vocab, (1, 515),
                         generator=torch.Generator().manual_seed(5))
    logits, cache = engine.prefill(toks[:, :512].numpy(), max_len=520)
    got = [logits[0]]
    names = ("decode.graph_captures", "decode.graph_replays",
             "decode.eager_steps")
    before = [tracing.counters().get(n, 0) for n in names]
    with torch.no_grad():
        for t in range(512, 515):
            logits, cache = engine.model.decode_step(params, cache,
                                                     toks[:, t].to(card))
            got.append(logits[0])
    after = [tracing.counters().get(n, 0) for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0]
    blocks.float32_matmuls()
    with torch.no_grad():
        ref = _bench_reference("zamba2-7b-instruct").logits(
            params, dataclasses.asdict(cfg), toks[0].to(card),
            list(range(511, 515)), blocks.Matmul(False))
    for g, r in zip(got, ref):
        err = float((g.float() - r).norm() / r.norm())
        assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_published_zamba2_decode_graph_is_the_eager_body_on_card(card,
                                                                 dtype):
    """One period of the published widths, 6 decode steps from a
    512-token prefill through ``decode_step`` (the graph) and through the
    eager body on a copy: the logits and every cache tensor bit-equal
    after every step, the length among them.  Counters: one capture, five
    replays, no eager step; the shared block's applications are counted
    where its code runs, the graph's warm-up and capture, and not by a
    replay."""
    from repro_torch import tracing
    from repro_torch.models.decode_graph import WARMUP
    cfg, model, params = _published_period(card, dtype)
    prompt = torch.randint(0, cfg.vocab, (1, 512), device=card,
                           generator=torch.Generator(card).manual_seed(5))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": prompt}, max_len=520)
    mine = {k: v.clone() for k, v in cache.items() if k != "len"}
    mine["len"] = torch.tensor(512, device=card)
    tok = torch.zeros(1, dtype=torch.int64, device=card)
    tracing.reset_counters()
    with torch.no_grad():
        for step in range(6):
            apps = tracing.counters().get("hybrid.shared_apps", 0)
            got, cache = model.decode_step(params, cache, tok)
            apps = tracing.counters()["hybrid.shared_apps"] - apps
            assert apps == (cfg.n_apps * (WARMUP + 1) if step == 0 else 0)
            want, mine = model._decode_eager(params, mine, tok)
            assert torch.equal(got, want), step
            for name in mine:
                assert torch.equal(cache[name], mine[name]), (step, name)
            assert int(cache["len"]) == 513 + step
            tok = got.argmax(-1)
    got = tracing.counters()
    assert (got["decode.graph_captures"], got["decode.graph_replays"],
            got.get("decode.eager_steps", 0)) == (1, 5, 0)


@pytest.mark.cuda
def test_published_zamba2_graph_stays_off_with_grad_or_a_dispatch_mode_on_card(
        card):
    """As the ssm family's: autograd on, or the dry run's cost trace
    active, runs the published block's eager body, counted as eager steps
    (and its applications of the shared blocks), and the cost trace sees
    every operation."""
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.launch.cost import CostTrace
    from repro_torch.models import get_model, init_params
    cfg = get_config("zamba2-7b-instruct").reduced(
        head_dim=32, attn_scale=16 ** -0.5, ssm_chunk=8)
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(card).manual_seed(1), card)
    cache = model.init_cache(1, 16, device=card)
    tok = torch.zeros(1, dtype=torch.int64, device=card)
    tracing.reset_counters()
    model.decode_step(params, cache, tok)
    with torch.no_grad(), CostTrace() as tr:
        model.decode_step(params, cache, tok)
    assert tr.ops > 100 and tr.flops > 0
    assert tracing.counters() == {"decode.eager_steps": 2,
                                  "hybrid.shared_apps": 2 * cfg.n_apps}
    assert not model._graphs._graphs
