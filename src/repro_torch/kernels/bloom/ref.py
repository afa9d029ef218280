"""Plain PyTorch version of the Bloom-probe kernel (any device).

Hash family (the JAX package's ``kernels/bloom/ref.py``): 32-bit double
hashing over two murmur3-finaliser streams,

    h1 = mix32(key ^ seed * 0x9E3779B9),   h2 = mix32(key ^ 0x85EBCA6B) | 1,
    idx_i = (h1 + i * h2) mod 2^32 mod m,  i = 0 .. k-1,

with keys taken as their low 32 bits and the seed modulo 2^32.  Bitmaps
are byte-packed: bit ``i`` of a filter lives in byte ``i >> 3`` at lane
``i & 7``.

torch has ``uint32`` but not its ``>>``, ``+`` or ``%`` on the CPU, so
everything here is ``int64`` holding values in [0, 2^32) and masked back
after each wrapping step.  Products never leave int64: a 32-bit value
times a 32-bit constant is taken as two products by the constant's 16-bit
halves (each < 2^48), and only the low 16 bits of the high half's product
survive the shift (:func:`_mul32`).  ``i * h2`` is below k * 2^32.
"""
from __future__ import annotations

import torch

I64 = torch.int64
MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9          # per-cache seed multiplier
H2_SALT = 0x85EBCA6B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, without an int64 product above 2^48."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finaliser on int64 lanes in [0, 2^32) (the
    shifts are logical because every lane is non-negative)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def as_u32(keys: torch.Tensor) -> torch.Tensor:
    """Keys as int64 lanes holding their low 32 bits (``astype(uint32)``:
    two's complement wrap for negative int32)."""
    return keys.to(I64) & MASK32


def seed_word(seed: int) -> int:
    """``seed * 0x9E3779B9 mod 2^32`` for any Python int seed."""
    return (int(seed) & MASK32) * GOLDEN32 & MASK32


def hash_h2(keys32: torch.Tensor) -> torch.Tensor:
    """The seed-independent step ``h2`` (odd), [B] int64."""
    return _mix32(keys32 ^ H2_SALT) | 1


def hash_idx(keys: torch.Tensor, k: int, m: int, seed: int = 0,
             h2: torch.Tensor = None) -> torch.Tensor:
    """[B, k] int64 bit indices in [0, m) via double hashing."""
    keys32 = as_u32(keys)
    h1 = _mix32(keys32 ^ seed_word(seed))
    if h2 is None:
        h2 = hash_h2(keys32)
    i = torch.arange(k, dtype=I64, device=keys.device)
    return ((h1[:, None] + i[None, :] * h2[:, None]) & MASK32) % m


def pack_bits(bits01: torch.Tensor) -> torch.Tensor:
    """[m] 0/1 uint8 (m % 8 == 0) -> [m / 8] byte-packed uint8."""
    lanes = torch.arange(8, dtype=I64, device=bits01.device)
    return (bits01.reshape(-1, 8).to(I64) << lanes).sum(dim=1).to(torch.uint8)


def build_indicator_ref(keys: torch.Tensor, m: int, k: int,
                        seed: int = 0) -> torch.Tensor:
    """Byte-packed bitmap [m / 8] uint8 of a key set (m % 8 == 0)."""
    if m % 8:
        raise ValueError(f"m must be a multiple of 8, got {m}")
    bits01 = torch.zeros(m, dtype=torch.uint8, device=keys.device)
    bits01[hash_idx(keys, k, m, seed).reshape(-1)] = 1
    return pack_bits(bits01)


def bloom_probe_ref(bits: torch.Tensor, keys: torch.Tensor, k: int,
                    seeds=None) -> torch.Tensor:
    """bits [n, m_bytes] uint8, keys [B] integer -> [B, n] int8: 1 where
    all k probed bits of cache j's bitmap are set.  ``seeds``: per-cache
    Python ints (default: the cache index)."""
    n, mbytes = bits.shape
    m = mbytes * 8
    seeds = list(range(n)) if seeds is None else [int(s) for s in seeds]
    h2 = hash_h2(as_u32(keys))
    out = torch.empty((keys.shape[0], n), dtype=torch.int8,
                      device=keys.device)
    for j in range(n):
        idx = hash_idx(keys, k, m, seeds[j], h2=h2)            # [B, k]
        vals = bits[j][idx >> 3].to(I64)
        out[:, j] = ((vals >> (idx & 7)) & 1).all(dim=1).to(torch.int8)
    return out
