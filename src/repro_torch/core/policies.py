"""Cache-selection policies.

* :func:`hocs_fna`       — Algorithm 1 (optimal, fully-homogeneous; Thm. 4)
* :func:`ds_pgm`         — the FNO subroutine of [14] (prefix evaluation in
                           potential-gain order; log(M)-approx for the
                           restricted CS problem)
* :func:`exhaustive`     — exact minimiser of Eq. (10) (small n)
* :func:`cs_fna`         — Algorithm 2: false-negative AWARE selection via
                           the Theorem-7 reduction (negative-indication
                           caches participate with rho = nu)
* :func:`cs_fno`         — false-negative OBLIVIOUS baseline: positive
                           indications only, rho = pi (nu treated as 1)
* :func:`perfect_information` — the PI lower-bound strategy
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

from repro_torch.core.model import (
    EPS,
    CacheView,
    service_cost,
)

Selection = List[int]
RestrictedAlg = Callable[[Sequence[float], Sequence[float], float], Selection]


# ---------------------------------------------------------------------------
# Algorithm 1: fully homogeneous
# ---------------------------------------------------------------------------

def _argmin_geometric(m_eff: float, rho: float, r_max: int) -> int:
    """argmin_{0<=r<=r_max} r + m_eff * rho^r  (strictly convex in r)."""
    if r_max <= 0:
        return 0
    if rho <= EPS:
        return 1 if m_eff > 1.0 else 0
    if rho >= 1.0 - EPS:
        return 0
    # continuous optimum: r* = ln(m_eff * ln(1/rho)) / ln(1/rho)
    l = math.log(1.0 / rho)
    r_cont = math.log(max(m_eff * l, EPS)) / l
    best_r, best_v = 0, m_eff
    # ascending candidate order + strict-improvement test: on a tie (within
    # EPS) the smaller r is kept, as documented
    for r in sorted({0, 1, int(math.floor(r_cont)), int(math.ceil(r_cont)), r_max}):
        if 0 <= r <= r_max:
            v = r + m_eff * rho ** r
            if v < best_v - EPS:
                best_r, best_v = r, v
    return best_r


def hocs_fna(n_x: int, n: int, pi: float, nu: float, miss_penalty: float
             ) -> Tuple[int, int]:
    """Algorithm 1: returns (r0*, r1*) = #negative / #positive accesses."""
    r1 = _argmin_geometric(miss_penalty, pi, n_x)
    r0 = 0
    residual = miss_penalty * (pi ** r1)
    if residual > 1.0:
        r0 = _argmin_geometric(residual, nu, n - n_x)
    return r0, r1


# ---------------------------------------------------------------------------
# Heterogeneous subroutines (restricted CS problem of [14])
# ---------------------------------------------------------------------------

def ds_pgm(costs: Sequence[float], rhos: Sequence[float], miss_penalty: float
           ) -> Selection:
    """Potential-gain order + prefix evaluation (DS_PGM of [14]).

    Sort caches by c_j / -ln(rho_j) (cost per unit of log-miss reduction;
    the optimal insertion order by an exchange argument), then return the
    best prefix of that order under Eq. (10) — including the empty prefix.
    """
    n = len(costs)

    def key(j: int) -> float:
        r = min(max(rhos[j], EPS), 1.0 - EPS)
        return costs[j] / -math.log(r)

    order = sorted(range(n), key=key)
    best_sel: Selection = []
    best_cost = miss_penalty  # empty prefix
    run_cost, run_prod = 0.0, 1.0
    for i, j in enumerate(order):
        run_cost += costs[j]
        run_prod *= rhos[j]
        v = run_cost + miss_penalty * run_prod
        if v < best_cost - EPS:
            best_cost = v
            best_sel = order[: i + 1]
    return sorted(best_sel)


def ds_pgm_mask(costs: Sequence[float], rhos: Sequence[float],
                miss_penalty: float) -> int:
    """:func:`ds_pgm` returning the selection as a bitmask.

    Decision-identical to ``ds_pgm`` (same key values, same stable sort,
    same EPS dead-band on the prefix scan) with the per-call overhead
    stripped — this is the scalar inner call of the calibrated fast
    engine's bridge/table paths, where it runs tens of thousands of times
    per replay.
    """
    n = len(costs)
    keys = [costs[j] / -math.log(min(max(rhos[j], EPS), 1.0 - EPS))
            for j in range(n)]
    order = sorted(range(n), key=keys.__getitem__)
    best_mask = 0
    best_cost = miss_penalty
    run_mask = 0
    run_cost, run_prod = 0.0, 1.0
    for j in order:
        run_cost += costs[j]
        run_prod *= rhos[j]
        run_mask |= 1 << j
        v = run_cost + miss_penalty * run_prod
        if v < best_cost - EPS:
            best_cost = v
            best_mask = run_mask
    return best_mask


def exhaustive(costs: Sequence[float], rhos: Sequence[float], miss_penalty: float
               ) -> Selection:
    """Exact minimiser of Eq. (10) over all 2^n subsets (n <= 20)."""
    n = len(costs)
    if n > 20:
        raise ValueError("exhaustive() limited to n <= 20")
    best_sel: Selection = []
    best_cost = miss_penalty
    for mask in range(1, 1 << n):
        c, p = 0.0, miss_penalty
        for j in range(n):
            if mask >> j & 1:
                c += costs[j]
                p *= rhos[j]
                if c >= best_cost:  # prune
                    break
        else:
            v = c + p
            if v < best_cost - EPS:
                best_cost = v
                best_sel = [j for j in range(n) if mask >> j & 1]
    return best_sel


def exhaustive_mask(costs: Sequence[float], rhos: Sequence[float],
                    miss_penalty: float) -> int:
    """:func:`exhaustive` returning the selection as a bitmask.

    Decision-identical to ``exhaustive`` (same ascending-mask enumeration,
    same pruning, same EPS dead-band) with the per-call overhead stripped —
    the scalar inner call of the calibrated fast engine's bridge/table
    paths when the exhaustive subroutine is configured.
    """
    n = len(costs)
    if n > 20:
        raise ValueError("exhaustive_mask() limited to n <= 20")
    best_mask = 0
    best_cost = miss_penalty
    for mask in range(1, 1 << n):
        c, p = 0.0, miss_penalty
        for j in range(n):
            if mask >> j & 1:
                c += costs[j]
                p *= rhos[j]
                if c >= best_cost:  # prune
                    break
        else:
            v = c + p
            if v < best_cost - EPS:
                best_cost = v
                best_mask = mask
    return best_mask


# ---------------------------------------------------------------------------
# Algorithm 2: CS_FNA / CS_FNO
# ---------------------------------------------------------------------------

def rho_vector(views: Sequence[CacheView], indications: Sequence[int]) -> List[float]:
    """rho_j = pi_j if I_j(x)=1 else nu_j  (lines 5-10 of Algorithm 2)."""
    rhos = []
    for v, ind in zip(views, indications):
        pi, nu = v.exclusions()
        rhos.append(pi if ind else nu)
    return rhos


def cs_fna(views: Sequence[CacheView], indications: Sequence[int],
           miss_penalty: float, alg: RestrictedAlg = ds_pgm) -> Selection:
    """Algorithm 2: all caches are candidates; negative indications carry
    rho = nu (Theorem-7 reduction to the restricted CS problem)."""
    costs = [v.cost for v in views]
    rhos = rho_vector(views, indications)
    return alg(costs, rhos, miss_penalty)


def cs_fno(views: Sequence[CacheView], indications: Sequence[int],
           miss_penalty: float, alg: RestrictedAlg = ds_pgm) -> Selection:
    """FNO baseline: only positive-indication caches may be accessed
    (equivalently nu_j = 1 for all j)."""
    pos = [j for j, ind in enumerate(indications) if ind]
    if not pos:
        return []
    costs = [views[j].cost for j in pos]
    rhos = [views[j].exclusions()[0] for j in pos]
    sel = alg(costs, rhos, miss_penalty)
    return sorted(pos[i] for i in sel)


def perfect_information(costs: Sequence[float], contains: Sequence[bool]) -> Selection:
    """PI strategy: access the cheapest cache that truly holds x, else none."""
    best, best_c = None, None
    for j, has in enumerate(contains):
        if has and (best_c is None or costs[j] < best_c):
            best, best_c = j, costs[j]
    return [] if best is None else [best]


def expected_cost(views: Sequence[CacheView], indications: Sequence[int],
                  selection: Selection, miss_penalty: float) -> float:
    """Model-expected phi(D) for a selection (Eq. 4/10 with estimated rho)."""
    costs = [v.cost for v in views]
    rhos = rho_vector(views, indications)
    return service_cost(costs, rhos, miss_penalty, selection)
