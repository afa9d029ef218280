"""Advertisement-event subsystem: when a cache advertises, and what it
costs on the wire (arXiv:2104.01386 / arXiv:2405.17801).  A copy of the
JAX package's ``repro.cachesim.advert``.

The paper models advertisement as a fixed per-cache insertion cadence
(``update_interval``).  The follow-up papers make it a budgeted,
adaptive resource: a cache decides *when* to advertise (on measured
staleness drift, within a bandwidth budget) and *what* (full indicator
vs delta).  This module is the single shared implementation of those
decisions — both engines call the SAME functions at the SAME system
state, which is what makes the reference loop and the fast engine's
event walk bit-exact twins on every advert policy:

``periodic``
    The paper's fixed cadence, unchanged: advertise after
    ``update_interval`` insertions, transmitting the full ``m``-bit
    bitmap.  The pre-existing behaviour is a strict special case of the
    event subsystem (golden files reproduce byte-identically).

``delta``
    Same cadence, delta transmission: the wire cost is the measured
    changed-bit encoding (changed positions x ceil(log2 m) bits) capped
    at the full bitmap — the ``what`` axis of arXiv:2405.17801.  System
    evolution is identical to ``periodic``; only bytes-on-wire differ.

``self_adjusting``
    Drift-triggered advertisement under a token-bucket bandwidth budget
    (arXiv:2104.01386).  Every ``advert_check`` insertions the cache
    refills its bucket (``advert_bandwidth`` bytes per insertion, capped
    at ``advert_burst``) and advertises iff the Eq. (7) false-negative
    prediction from the live (updated, stale) bitmap pair has crossed
    ``advert_threshold`` AND the bucket covers a full advertisement.
    ``update_interval`` does not trigger adverts in this mode.

Every advertisement is recorded as an event ``(insertion ordinal,
bytes)`` on the cache node; :class:`~repro_torch.cachesim.systemstate.
SystemTrace` snapshots the per-cache event streams so stored sweeps
carry them, and the sweep records expose the totals per run.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

#: the pluggable policy family (``SimConfig.advert_policy``)
ADVERT_POLICIES = ("periodic", "delta", "self_adjusting")


def full_advert_bytes(ind) -> float:
    """Wire cost of a full bitmap advertisement: ``m`` bits."""
    return ind.cbf.m / 8.0


def delta_advert_bytes(ind) -> float:
    """Measured delta-encoding cost of advertising NOW: the bits that
    changed since the last advertisement, each as a ceil(log2 m)-bit
    position, capped at the full bitmap (the receiver can always be sent
    the whole thing instead).  Must be called BEFORE ``advertise()`` —
    it reads the (updated, stale) pair."""
    updated = ind.cbf.to_bitmap()
    changed = int(np.count_nonzero(updated != ind.stale))
    pos_bits = max(1, math.ceil(math.log2(max(ind.cbf.m, 2))))
    return min(full_advert_bytes(ind), changed * pos_bits / 8.0)


def advert_cost(ind, policy: str) -> float:
    """Wire cost of the advertisement a ``periodic``/``delta`` cache is
    about to make (before ``advertise()``)."""
    if policy == "delta":
        return delta_advert_bytes(ind)
    return full_advert_bytes(ind)


def predicted_fn(ind) -> float:
    """Eq. (7) false-negative prediction from the live (updated, stale)
    bitmap pair, WITHOUT mutating ``fp_est``/``fn_est`` — the drift
    signal of the self-adjusting policy.  Identical arithmetic to
    ``StaleIndicatorPair.estimate_rates``."""
    updated = ind.cbf.to_bitmap()
    b1 = int(np.count_nonzero(updated))
    if b1 == 0:
        return 0.0
    d1 = int(np.count_nonzero(updated & ~ind.stale))
    return 1.0 - ((b1 - d1) / b1) ** ind.cbf.k


def refill(tokens: float, burst: float, bandwidth: float,
           elapsed: int) -> float:
    """Token-bucket refill after ``elapsed`` insertions (both engines
    refill in the same check-boundary jumps, so the float arithmetic —
    one multiply-add and one min per boundary — is identical)."""
    return min(burst, tokens + bandwidth * elapsed)


def self_adjusting_decision(ind, tokens: float,
                            threshold: float) -> Optional[float]:
    """The drift/budget gate: the cost of the advertisement to make now,
    or None to stay silent.  Advertise iff predicted FN drift crossed
    ``threshold`` and the bucket covers a full advertisement."""
    cost = full_advert_bytes(ind)
    if predicted_fn(ind) >= threshold and tokens >= cost:
        return cost
    return None


def resolve_advert(cfg) -> Tuple[tuple, ...]:
    """The canonical per-cache advert spec — one ``(policy, bandwidth,
    burst bytes, threshold, check interval)`` tuple per cache, defaults
    resolved (burst 0 -> one full advertisement; check 0 -> the cache's
    ``est_interval``).  This is the ``system_key`` component: a scalar
    and its broadcast sequence resolve identically, and knobs a policy
    does not read are zeroed so they cannot split sweep-sharing groups
    (a ``periodic`` cache's evolution ignores the budget fields)."""
    out = []
    pols = cfg.advert_policies
    bws, bursts = cfg.advert_bandwidths, cfg.advert_bursts
    ths, chks = cfg.advert_thresholds, cfg.advert_checks
    for j in range(cfg.n_caches):
        pol = pols[j]
        if pol == "self_adjusting":
            m = int(cfg.bpes[j] * cfg.cache_sizes[j])
            burst = bursts[j] if bursts[j] > 0 else m / 8.0
            chk = chks[j] if chks[j] > 0 else cfg.est_intervals[j]
            out.append((pol, float(bws[j]), float(burst),
                        float(ths[j]), int(chk)))
        else:
            out.append((pol, 0.0, 0.0, 0.0, 0))
    return tuple(out)
