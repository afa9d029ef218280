"""Synthetic trace generators standing in for the paper's workloads.

The paper evaluates on Wiki / Gradle / Scarab / F2 traces that are not
redistributable offline, so we generate seeded synthetic traces matching
their qualitative structure (Sec. V-B of the paper characterises what
matters for FNA behaviour):

  * ``wiki``   — frequency-biased: bounded Zipf(0.99) over a large catalog;
                 popular items stay popular, few compulsory misses.
  * ``gradle`` — recency-biased: a stream of NEW objects each re-requested
                 shortly after first appearance (build artifacts), i.e.
                 high stack-locality and a constantly-moving working set.
                 This is the regime where staleness hurts FNO the most.
  * ``scarab`` — mixture of a Zipf head with a churning recency tail.
  * ``f2``     — financial transactions: looping scans over a block of
                 records plus a hot set.

Each generator is deterministic given (n, seed), and bit-identical to the
JAX package's ``repro.cachesim.traces`` (a copy).  File-backed traces
(``repro.cachesim.tracefiles``) are not ported yet; callers pass such a
trace in as an array.
"""
from __future__ import annotations

import numpy as np

TRACES = ("wiki", "gradle", "scarab", "f2")


def _bounded_zipf_cdf(catalog: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, catalog + 1, dtype=np.float64)
    w = ranks ** -alpha
    return np.cumsum(w) / w.sum()


def zipf_trace(n: int, catalog: int = 400_000, alpha: float = 0.99,
               seed: int = 0, drift: float = 0.01) -> np.ndarray:
    """Zipf with slow popularity DRIFT: the rank->item mapping slides by one
    position every 1/drift requests, so trending items continuously enter
    the popular head (real Wikipedia traffic is non-stationary; a perfectly
    stationary Zipf would make staleness-induced false negatives vanishingly
    rare, which no measured wiki workload shows — cf. paper Fig. 1)."""
    rng = np.random.default_rng(seed)
    cdf = _bounded_zipf_cdf(catalog, alpha)
    u = rng.random(n)
    ranks = np.searchsorted(cdf, u)
    shift = (np.arange(n) * drift).astype(np.int64)
    ids = (ranks + shift) % catalog
    # shuffle rank->id so popularity isn't correlated with id value
    perm = rng.permutation(catalog)
    return perm[ids].astype(np.int64)


def _recency_trace_ref(n: int, p_new: float = 0.25, window: int = 4096,
                       alpha: float = 1.2, seed: int = 0) -> np.ndarray:
    """Per-request reference loop for :func:`recency_trace` (kept as the
    bit-exactness oracle for the vectorised generator)."""
    rng = np.random.default_rng(seed)
    cdf = _bounded_zipf_cdf(window, alpha)
    out = np.empty(n, dtype=np.int64)
    hist = np.empty(n + window, dtype=np.int64)
    next_id = 0
    # seed the window
    for i in range(window):
        hist[i] = next_id = next_id + 1
    hlen = window
    us = rng.random(n)
    ds = np.searchsorted(cdf, rng.random(n)) + 1
    for i in range(n):
        if us[i] < p_new:
            next_id += 1
            x = next_id
        else:
            x = hist[hlen - int(ds[i])]
        out[i] = x
        hist[hlen] = x
        hlen += 1
    return out


def recency_trace(n: int, p_new: float = 0.25, window: int = 4096,
                  alpha: float = 1.2, seed: int = 0) -> np.ndarray:
    """Gradle-like: new ids arrive constantly; re-references target recent
    history with a Zipf-distributed stack distance.

    Vectorised via pointer doubling, bit-identical to the per-request
    loop (``_recency_trace_ref``) for every (n, seed): a re-reference at
    position i copies stream position ``i - d_i`` — a seed-window slot
    (value known in closed form) or an earlier output — so each request
    is a chain of strictly-decreasing pointers ending at a new id or a
    seed slot.  New ids are a cumulative count; chains collapse in
    O(log chain) vectorised pointer-jumping passes instead of n scalar
    steps (this generator dominates 1M+-request sweep setup otherwise).
    """
    rng = np.random.default_rng(seed)
    cdf = _bounded_zipf_cdf(window, alpha)
    us = rng.random(n)
    ds = np.searchsorted(cdf, rng.random(n)) + 1        # stack distances
    is_new = us < p_new
    out = np.where(is_new, window + np.cumsum(is_new), 0)
    ptr = np.arange(n, dtype=np.int64) - ds             # back-reference
    seed_ref = ~is_new & (ptr < 0)                      # into the seed window
    out[seed_ref] = window + ptr[seed_ref] + 1          # hist[j] = j + 1
    resolved = is_new | seed_ref
    unres = np.flatnonzero(~resolved)
    while unres.size:
        tgt = ptr[unres]
        done = resolved[tgt]
        hit = unres[done]
        out[hit] = out[tgt[done]]
        resolved[hit] = True
        rest = unres[~done]
        # target unresolved => value[target] = value[ptr[target]]: jump
        ptr[rest] = ptr[ptr[rest]]
        unres = rest
    return out


def mixed_trace(n: int, seed: int = 0) -> np.ndarray:
    """Scarab-like: 60% Zipf head / 40% recency churn (disjoint id spaces)."""
    rng = np.random.default_rng(seed)
    z = zipf_trace(n, catalog=100_000, alpha=0.9, seed=seed + 1)
    r = recency_trace(n, p_new=0.35, window=2048, seed=seed + 2) + 10_000_000
    pick = rng.random(n) < 0.6
    return np.where(pick, z, r)


def loop_scan_trace(n: int, block: int = 30_000, hot: int = 2_000,
                    p_hot: float = 0.3, seed: int = 0) -> np.ndarray:
    """F2-like: sequential scans over a records block + a hot set."""
    rng = np.random.default_rng(seed)
    scan = (np.arange(n, dtype=np.int64) % block) + 1_000_000
    hot_ids = rng.integers(0, hot, n)
    pick = rng.random(n) < p_hot
    return np.where(pick, hot_ids, scan)


def get_trace(name: str, n: int, seed: int = 0, **kwargs) -> np.ndarray:
    """Generate a named synthetic trace (``wiki``/``gradle``/``scarab``/
    ``f2``); ``kwargs`` pass through as catalog / skew / churn knobs, and
    the no-kwargs call stays bit-identical per (name, n, seed)."""
    if name == "wiki":
        return zipf_trace(n, seed=seed, **kwargs)
    if name == "gradle":
        return recency_trace(n, seed=seed, **kwargs)
    if name == "scarab":
        return mixed_trace(n, seed=seed, **kwargs)
    if name == "f2":
        return loop_scan_trace(n, seed=seed, **kwargs)
    raise KeyError(f"unknown trace {name!r}; known generators: {TRACES}")
