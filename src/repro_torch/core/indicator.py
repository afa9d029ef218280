"""Bloom-filter indicators with staleness (paper Sec. IV-A/IV-B).

The cache keeps a Counting Bloom Filter for bookkeeping (supports
eviction), compresses it to a plain bitmap for advertisement, and keeps the
last advertised ("stale") bitmap to estimate the staleness-induced
false-negative / false-positive ratios via Eqs. (7)-(8):

  FN_t = 1 - [ (B1 - D1) / B1 ]^k                       (7)
  FP_t = [ (B1 - D1 + D0) / m ]^k                       (8)

where B1 = #set bits in the updated filter, D1 = bits set in the updated
filter but clear in the stale one, D0 = the converse.

Hashing: k indexes via double hashing of two splitmix64 streams — fast,
vectorisable (numpy), and identical in the JAX/Pallas kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

MASK64 = (1 << 64) - 1


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser (uint64 in/out)."""
    z = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(MASK64)
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(MASK64)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(MASK64)
    return z ^ (z >> np.uint64(31))


def optimal_k(bpe: float) -> int:
    """k minimising the false-positive ratio: k = ln2 * bpe (>= 1)."""
    return max(1, round(math.log(2.0) * bpe))


def hash_indices(keys: np.ndarray, k: int, m: int, seed: int = 0) -> np.ndarray:
    """[len(keys), k] bit indices via double hashing."""
    keys = np.asarray(keys, dtype=np.uint64)
    h1 = splitmix64(keys ^ np.uint64(seed * 0x9E3779B97F4A7C15 & MASK64))
    h2 = splitmix64(keys ^ np.uint64(0xDEADBEEFCAFEBABE)) | np.uint64(1)
    i = np.arange(k, dtype=np.uint64)[None, :]
    return ((h1[:, None] + i * h2[:, None]) % np.uint64(m)).astype(np.int64)


class CountingBloomFilter:
    """CBF with small counters; compressible to a plain bitmap."""

    def __init__(self, m: int, k: int, seed: int = 0):
        self.m = int(m)
        self.k = int(k)
        self.seed = seed
        self.counters = np.zeros(self.m, dtype=np.uint8)

    def _idx(self, key: int) -> np.ndarray:
        return hash_indices(np.asarray([key]), self.k, self.m, self.seed)[0]

    def add(self, key: int) -> None:
        idx = self._idx(key)
        # saturating add (3-bit counters saturate at 7 in the paper; uint8
        # here — overflow is equally impossible for our cache sizes)
        self.counters[idx] = np.minimum(self.counters[idx].astype(np.int32) + 1, 255)

    def remove(self, key: int) -> None:
        idx = self._idx(key)
        c = self.counters[idx].astype(np.int32) - 1
        self.counters[idx] = np.maximum(c, 0)

    def query(self, key: int) -> bool:
        return bool(np.all(self.counters[self._idx(key)] > 0))

    def to_bitmap(self) -> np.ndarray:
        """Advertised 1-bit indicator: bit set iff counter > 0."""
        return self.counters > 0


class StaleIndicatorPair:
    """Cache-side state: updated CBF + last-advertised (stale) bitmap.

    Exposes Eq. (7)/(8) estimation and client-visible stale queries.
    """

    def __init__(self, m: int, k: int, seed: int = 0):
        self.cbf = CountingBloomFilter(m, k, seed)
        self.stale = np.zeros(m, dtype=bool)
        self.fn_est = 0.0
        self.fp_est = 0.0

    # --- cache side -------------------------------------------------------
    def advertise(self) -> np.ndarray:
        """Publish a fresh bitmap (the client replaces its replica)."""
        self.stale = self.cbf.to_bitmap().copy()
        return self.stale

    def estimate_rates(self) -> Tuple[float, float]:
        """Eqs. (7)-(8) from the (updated, stale) pair."""
        updated = self.cbf.to_bitmap()
        b1 = int(np.count_nonzero(updated))
        d1 = int(np.count_nonzero(updated & ~self.stale))
        d0 = int(np.count_nonzero(~updated & self.stale))
        k, m = self.cbf.k, self.cbf.m
        if b1 > 0:
            self.fn_est = 1.0 - ((b1 - d1) / b1) ** k
        else:
            self.fn_est = 0.0
        self.fp_est = ((b1 - d1 + d0) / m) ** k
        return self.fp_est, self.fn_est

    # --- client side ------------------------------------------------------
    def stale_query(self, key: int) -> bool:
        idx = hash_indices(np.asarray([key]), self.cbf.k, self.cbf.m, self.cbf.seed)[0]
        return bool(np.all(self.stale[idx]))

    def fresh_query(self, key: int) -> bool:
        return self.cbf.query(key)


def theoretical_fp(bpe: float, k: Optional[int] = None) -> float:
    """Designed false-positive ratio of a filter with ``k`` hash functions
    (``k=None`` picks the optimal count; an explicit ``k=0`` means no
    hashing at all and yields a degenerate always-positive filter)."""
    if k is None:
        k = optimal_k(bpe)
    return (1.0 - math.exp(-k / bpe)) ** k
