"""The port's Bloom indicator build and probe (``repro_torch.kernels.bloom``,
plain version on the CPU) against the JAX package's oracles.

The oracles are ``build_indicator_ref`` and ``bloom_probe_ref``, called
directly with Python-int seeds: the JAX wrapper ``bloom_probe`` passes
numpy int32 seeds into ``seed * 0x9E3779B9``, which overflows under
numpy 2, and its Pallas path needs ``pl.load``, which JAX 0.9 removed.

Tolerance: none.  Bitmaps are compared byte for byte and indications
exactly.  Inputs are made from numpy seeds; both sides get the same
arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bloom.ref import bloom_probe_ref as jax_probe_ref
from repro.kernels.bloom.ref import build_indicator_ref as jax_build_ref
from repro_torch.core import optimal_k
from repro_torch.kernels.bloom import (
    LAUNCHES,
    bloom_probe,
    bloom_probe_ref,
    build_indicator,
    build_indicator_ref,
)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _int32_keys(rng, n):
    keys = rng.integers(INT32_MIN, INT32_MAX, n, endpoint=True)
    keys[:4] = [INT32_MIN, INT32_MAX, -1, 0]
    return keys.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 5, 2 ** 31 - 1])
@pytest.mark.parametrize("k", [3, 7, 10])
@pytest.mark.parametrize("m", [16_384, 140_000, 8_000])
def test_build_indicator_matches_reference(m, k, seed):
    keys = _int32_keys(np.random.default_rng(m + 31 * k + seed), 300)
    want = np.asarray(jax_build_ref(jnp.asarray(keys), m, k, seed))
    got = build_indicator(keys, m, k, seed, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (m // 8,)
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(build_indicator_ref(torch.as_tensor(keys), m, k,
                                           seed), got)


def test_build_indicator_chunks_like_one_scatter(monkeypatch):
    """The chunked build (here 7 keys a step) equals the plain one-shot
    scatter."""
    import repro_torch.kernels.bloom.ops as ops
    keys = torch.as_tensor(_int32_keys(np.random.default_rng(3), 100))
    whole = build_indicator_ref(keys, 8_000, 7, 2)
    monkeypatch.setattr(ops, "BUILD_CHUNK", 7)
    assert torch.equal(build_indicator(keys, 8_000, 7, 2), whole)


def _bitmaps(rng, mbytes, k, n_caches, seeds):
    """Per-cache member sets and their bitmaps, built by the port and
    checked against the reference's build on the way."""
    bits, members = [], []
    for j in range(n_caches):
        ks = _int32_keys(rng, 400)
        members.append(ks)
        got = build_indicator(ks, mbytes * 8, k, seeds[j], device="cpu")
        assert got.numpy().tobytes() == np.asarray(
            jax_build_ref(jnp.asarray(ks), mbytes * 8, k, seeds[j])).tobytes()
        bits.append(got.numpy())
    return np.stack(bits), members


@pytest.mark.parametrize("seeds", ["default", "custom"])
@pytest.mark.parametrize("mbytes,k,n_caches,n_keys", [
    (2048, 7, 2, 256),        # tests/test_kernels.py's parameter sets
    (4096, 10, 5, 512),
    (2048, 3, 1, 300),
    (1750, 10, 8, 600),       # the paper shape's m_bytes, not 2048-aligned
])
def test_bloom_probe_matches_reference(mbytes, k, n_caches, n_keys, seeds):
    rng = np.random.default_rng(42 + mbytes + n_keys)
    seed_list = list(range(n_caches)) if seeds == "default" else \
        [int(s) for s in rng.integers(INT32_MIN, INT32_MAX, n_caches)]
    bits, members = _bitmaps(rng, mbytes, k, n_caches, seed_list)
    # members of every cache, fresh keys, and the int32 extremes
    keys = np.concatenate([np.concatenate(members)[::3],
                           _int32_keys(rng, n_keys)])
    rng.shuffle(keys)
    want = np.asarray(jax_probe_ref(jnp.asarray(bits), jnp.asarray(keys), k,
                                    seeds=seed_list))
    got = bloom_probe(torch.as_tensor(bits), torch.as_tensor(keys), k=k,
                      seeds=None if seeds == "default" else seed_list)
    assert got.dtype == torch.int8 and got.shape == (keys.size, n_caches)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1       # both answers occur


def test_bloom_probe_takes_int64_keys_as_low_32_bits():
    """int64 keys hash as their low 32 bits (``astype(uint32)``), as the
    reference does under x64."""
    rng = np.random.default_rng(9)
    bits, members = _bitmaps(rng, 1024, 5, 2, [0, 1])
    keys = rng.integers(-2 ** 62, 2 ** 62, 500)
    keys[: members[0].size] = members[0].astype(np.int64) + (7 << 32)
    with jax.enable_x64():
        want = np.asarray(jax_probe_ref(jnp.asarray(bits), jnp.asarray(keys),
                                        5, seeds=[0, 1]))
    got = bloom_probe(torch.as_tensor(bits), torch.as_tensor(keys), k=5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[: members[0].size, 0].all()


def test_bloom_probe_no_false_negatives():
    mbytes, k = 2048, 8
    rng = np.random.default_rng(1)
    member = rng.integers(0, 1_000_000, 512).astype(np.int32)
    bits = build_indicator(member, mbytes * 8, k, seed=0, device="cpu")[None]
    out = bloom_probe(bits, torch.as_tensor(member), k=k)
    assert bool((out == 1).all())        # a fresh Bloom filter never FNs


def test_bloom_probe_fp_rate_sane():
    mbytes, k, n_items = 2048, 10, 1000  # bpe ~ 16
    rng = np.random.default_rng(2)
    member = rng.integers(0, 1_000_000, n_items)
    bits = build_indicator(member, mbytes * 8, k, seed=0, device="cpu")[None]
    probes = rng.integers(2_000_000, 9_000_000, 4096).astype(np.int32)
    fp = float(bloom_probe(bits, torch.as_tensor(probes), k=k).float().mean())
    assert fp < 0.01, fp                 # designed fp ~ 0.5^10


def test_paper_shape_indicator_fp_near_theory():
    """The router phase's paper shape: 10,000 keys at bpe 14 (m = 140,000
    bits, k = optimal_k(14) = 10); the measured FP rate of unseen keys
    stays near the designed (1 - e^{-k/bpe})^k ~ 7.7e-4."""
    k = optimal_k(14.0)
    assert k == 10
    members = torch.arange(10_000, dtype=torch.int64) * 7919
    bits = build_indicator(members, 140_000, k, device="cpu")[None]
    assert bool(bloom_probe(bits, members, k=k).all())
    unseen = torch.arange(10_000, 210_000, dtype=torch.int64) * 7919 + 1
    fp = float(bloom_probe(bits, unseen, k=k).float().mean())
    assert fp < 3e-3, fp


def test_cpu_probe_counts_no_launch():
    before = dict(LAUNCHES)
    bits = torch.zeros((2, 16), dtype=torch.uint8)
    out = bloom_probe(bits, torch.arange(5), k=3)
    assert out.tolist() == [[0, 0]] * 5
    assert LAUNCHES == before
    assert torch.equal(bloom_probe_ref(bits, torch.arange(5), 3), out)


def test_bloom_probe_rejects_bad_shapes():
    bits = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        bloom_probe(bits[0], torch.arange(5), k=3)
    with pytest.raises(ValueError):
        bloom_probe(torch.zeros((2, 0), dtype=torch.uint8), torch.arange(5),
                    k=3)
    with pytest.raises(ValueError):
        bloom_probe(bits, torch.arange(5), k=3, seeds=[1])
    with pytest.raises(ValueError):
        bloom_probe(bits, torch.arange(5), k=0)
    with pytest.raises(ValueError):
        build_indicator(torch.arange(5), 100, 3)


# ---------------------------------------------------------------------------
# A model of the CUDA kernel's index arithmetic (csrc/bloom.cu), in Python
# integers: h mod m by Lemire's fastmod with the host's 64-bit magic, then
# each next index by an add modulo m, corrected by 2^32 mod m whenever the
# 32-bit sum h1 + i*h2 wraps.  It must equal ``hash_idx``'s
# ``(h1 + i*h2) mod 2^32 mod m`` index for index.
# ---------------------------------------------------------------------------

M32, M64 = (1 << 32) - 1, (1 << 64) - 1


def _fastmod(a, magic, m):
    return ((magic * a) & M64) * m >> 64


def _kernel_indices(key32, seed, k, m):
    from repro_torch.kernels.bloom import ref
    mix = lambda x: int(ref._mix32(torch.tensor([x]))[0])  # noqa: E731
    magic = M64 // m + 1
    wrap = (1 << 32) % m
    h2 = mix(key32 ^ ref.H2_SALT) | 1
    d = _fastmod(h2, magic, m)
    e = d - wrap if d >= wrap else d + (m - wrap)
    x = mix(key32 ^ ref.seed_word(seed))
    y = _fastmod(x, magic, m)
    out, wraps = [y], 0
    for _ in range(1, k):
        x = (x + h2) & M32
        wrapped = x < h2
        wraps += wrapped
        a = e if wrapped else d
        y = y - (m - a) if y >= m - a else y + a
        assert 0 <= y < m
        out.append(y)
    return out, wraps


@pytest.mark.parametrize("m_bytes", [1, 3, 1750, 17_500, 70 << 20])
def test_kernel_modulo_model_matches_hash_idx(m_bytes):
    """The wrap-corrected modulo equals ``hash_idx`` for every probe, on
    keys whose ``h1 + i*h2`` wraps past 2^32 (each seed's keys wrap)."""
    from repro_torch.kernels.bloom import ref
    m, k = 8 * m_bytes, 10
    keys = _int32_keys(np.random.default_rng(m_bytes), 64).astype(np.int64)
    for seed in (0, 7, 2 ** 31 - 1):
        want = ref.hash_idx(torch.as_tensor(keys), k, m, seed).numpy()
        total_wraps = 0
        for key, row in zip(keys, want):
            got, wraps = _kernel_indices(int(key) & M32, seed, k, m)
            total_wraps += wraps
            assert got == row.tolist()
        assert total_wraps > 0
