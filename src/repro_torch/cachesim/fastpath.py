"""Fast engine, policy side: decision-plan dispatch + replay — the port of
the JAX package's ``repro.cachesim.fastpath``.

Bit-exact twin of ``Simulator._run_reference``, in phases (see the
``repro_torch.cachesim.simulator`` module docstring):

  1. SYSTEM SWEEP — ``repro_torch.cachesim.systemstate`` (host NumPy),
     computed once per (trace, system config) and shared across policies;
  2. DECISION PLAN — the provider registry of
     ``repro_torch.cachesim.engine``; table plans hold their
     ``[V * 2^n]`` tables on the sweep's device;
  3. REPLAY — :func:`accumulate_replay`: table gathers, hits and access
     popcounts run on the device; the service-cost accumulation stays a
     sequential float64 left fold on the host, so float-addition order
     matches the reference loop exactly (``torch.sum`` adds pairwise and
     would move ``total_cost`` by an ulp).

Parity caveat (as in the reference): the DS_PGM tables evaluate Eq. (10)
through ``exp(cumsum(log .))`` and a plain argmin, the scalar path through
a running product with an EPS (1e-12) improvement dead-band; the two can
only disagree when two prefix costs coincide to within ~1e-12.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.cachesim.simulator import SimResult, Simulator
from repro_torch.cachesim.systemstate import SystemTrace


def accumulate_replay(res: SimResult, st: SystemTrace, selm: torch.Tensor,
                      costs, miss_penalty: float) -> SimResult:
    """Fold per-request selection bitmasks ([N] int64 on ``st.device``)
    into the SimResult exactly as the reference loop would: per-mask cost
    sums in ascending cache order, hit iff the designated cache is both
    selected and resident, and a host-side scalar float fold so the
    cost-addition order matches bit-for-bit."""
    n = st.n
    k = 1 << n
    d = st.device_arrays()
    acc_by_mask = torch.as_tensor(
        [sum(costs[j] for j in range(n) if (m >> j) & 1) for m in range(k)],
        dtype=torch.float64, device=st.device)
    popcount = torch.as_tensor([bin(m).count("1") for m in range(k)],
                               dtype=torch.int64, device=st.device)
    hit_arr = d["in_dj"] & (((selm >> d["dj"]) & 1) != 0)
    acc = acc_by_mask[selm]
    cost_arr = torch.where(hit_arr, acc, acc + miss_penalty)
    pos_acc = int(popcount[selm & d["pats"]].sum())
    total_cost = res.total_cost
    for c in cost_arr.cpu().tolist():       # sequential, as the reference
        total_cost += c
    res.total_cost = total_cost
    res.hits += int(torch.count_nonzero(hit_arr))
    res.pos_accesses += pos_acc
    res.neg_accesses += int(popcount[selm].sum()) - pos_acc
    res.n_requests += st.trace_len
    return res


def run_fast(sim: Simulator, trace: np.ndarray, res: SimResult,
             system: Optional[SystemTrace] = None,
             chunk_size: Optional[int] = None, spill=None,
             report=None) -> SimResult:
    """Phases 1-3 for one policy (``report``: an optional
    ``repro_torch.cachesim.engine.RunReport`` receiving the phase times)."""
    from repro_torch.cachesim.engine import plan_for
    plan = plan_for(sim.cfg)
    if plan is None:
        # outside every provider's budget (n beyond the table limits):
        # the reference loop is the better deal
        return sim._run_reference(trace, res)
    if trace.shape[0] == 0:
        return res
    policy = sim.cfg.policy

    # --- phase 1: the shared system sweep (or a reused artifact) --------
    t0 = time.perf_counter()
    if system is None:
        system = SystemTrace.compute(sim, trace, chunk_size=chunk_size,
                                     spill=spill)
        system.device_arrays()
        if report is not None:
            report.system = system
            report.phase1_s += report.since(t0, sim.device)
            t0 = time.perf_counter()
    else:
        system.install(sim, trace)
    sim.last_system = system
    system.add_quality(res)
    system.add_advert(res)

    # --- phase 2: the decision plan's per-request selections ------------
    selm = plan.selections(sim, system)
    if report is not None:
        t0 = report.add("phase2_s", policy, t0, sim.device)

    # --- phase 3: replay -------------------------------------------------
    accumulate_replay(res, system, selm, list(sim.cfg.costs),
                      sim.cfg.miss_penalty)
    if report is not None:
        report.add("phase3_s", policy, t0, sim.device)
    return res
