"""Cost model for indicator-based multi-cache access (paper Sec. II).

Scalar implementations used by the trace simulator and the policies (a
copy of the JAX package's ``repro.core.model``: the port keeps its own
oracle arithmetic); ``repro_torch.core.batched`` holds the batched torch
twin.  Equation numbers reference the paper.

Note: Algorithm 2 line 6 of the paper prints h = (q - FN)/(1 - FP - FN);
inverting Eq. (1) actually gives h = (q - FP)/(1 - FP - FN), which is what
we implement (the printed form is a typo — it does not invert Eq. (1)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence, Tuple

EPS = 1e-12


def clamp01(x: float) -> float:
    return min(1.0, max(0.0, x))


def positive_indication_ratio(h: float, fp: float, fn: float) -> float:
    """Eq. (1):  q = h (1-FN) + (1-h) FP."""
    return h * (1.0 - fn) + (1.0 - h) * fp


def hit_ratio_from_q(q: float, fp: float, fn: float) -> float:
    """Inverse of Eq. (1):  h = (q - FP) / (1 - FP - FN), clamped to [0,1]."""
    denom = 1.0 - fp - fn
    if abs(denom) < EPS:
        return clamp01(q)
    return clamp01((q - fp) / denom)


def exclusion_probabilities(h: float, fp: float, fn: float) -> Tuple[float, float]:
    """Eqs. (2)-(3): positive/negative exclusion probabilities (pi, nu).

    pi = Pr(x not in S | I(x)=1) = FP (1-h) / q
    nu = Pr(x not in S | I(x)=0) = (1-FP)(1-h) / (1-q)
    """
    q = positive_indication_ratio(h, fp, fn)
    pi = clamp01(fp * (1.0 - h) / q) if q > EPS else 1.0
    nu = clamp01((1.0 - fp) * (1.0 - h) / (1.0 - q)) if (1.0 - q) > EPS else 0.0
    return pi, nu


def is_sufficiently_accurate(fp: float, fn: float) -> bool:
    """Sec. II: FP + FN < 1."""
    return fp + fn < 1.0


def service_cost(costs: Sequence[float], rhos: Sequence[float], miss_penalty: float,
                 selected: Iterable[int]) -> float:
    """Eq. (10): phi(D) = sum_{j in D} c_j + M * prod_{j in D} rho_j."""
    sel = list(selected)
    c = sum(costs[j] for j in sel)
    p = miss_penalty
    for j in sel:
        p *= rhos[j]
    return c + p


def phi_hat(r0: int, r1: int, nu: float, pi: float, miss_penalty: float) -> float:
    """Eq. (5), fully-homogeneous objective."""
    return r0 + r1 + miss_penalty * (nu ** r0) * (pi ** r1)


@dataclass
class CacheView:
    """Client-side view of one cache (inputs to the CS policies)."""
    cost: float
    fp: float
    fn: float
    q: float  # estimated positive-indication ratio (EWMA, Eq. 9)

    @property
    def h(self) -> float:
        return hit_ratio_from_q(self.q, self.fp, self.fn)

    def exclusions(self) -> Tuple[float, float]:
        return exclusion_probabilities(self.h, self.fp, self.fn)
