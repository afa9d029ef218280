"""Decision-plan layer of the fast engine: pluggable policy-table
providers and cross-cell sharing for decision-side axes — the port of the
JAX package's ``repro.cachesim.engine``.

The fast engine runs in three phases (see ``repro_torch.cachesim.simulator``):

  1. SYSTEM SWEEP — the policy-independent
     :class:`~repro_torch.cachesim.systemstate.SystemTrace` (NumPy, host);
  2. DECISION PLAN — this module: how a given (policy, subroutine)
     configuration turns the sweep's view history into per-request
     selections, with the ``[V * 2^n]`` tables built and held on the
     sweep's device;
  3. REPLAY — device gathers + the host's scalar cost fold
     (``repro_torch.cachesim.fastpath.accumulate_replay``).

The built-in registry, in match order:

  ================  =====================================================
  ``fna_cal``       speculative segmented replay
                    (``repro_torch.cachesim.fna_cal_fast``; NumPy, as in
                    the reference), its selections moved to the device
  ``pi``            the perfect-information lower bound: the membership
                    bit is the plan, computed on the device
  ``hocs``          Algorithm 1 tables via the exact NumPy mirror
                    ``repro_torch.core.batched.hocs_selection_tables``
  ``ds_pgm``        (version x pattern) tables in one torch float64
                    ``repro_torch.core.batched.selection_tables`` call
  ``exhaustive``    the 2^n-subset enumeration through the hand-written
                    subset-DP kernel (``exhaustive_tables``, n <= 12)
  ``scalar``        the generic fallback: one scalar ``sim.alg`` call per
                    (version, pattern) — the safety net for externally
                    registered scalar subroutines
  ================  =====================================================

Table plans memoise their tables on ``st.plan_cache`` keyed by the
decision-side configuration (costs, miss penalty, CS_FNO flag), which is
also the hand-off point of :func:`prefetch_tables`: cells that differ only
in plan inputs share ONE sweep, and their table builds stack into one
batched call per provider family.  :func:`run_cells` also consults the
content-addressed artifact store (``repro_torch.cachesim.store``): stored
sweeps hydrate onto the run's device, stored tables load onto it, and
new ones are saved after the replays.  The reference's device mesh (the
cell axis sharded over several devices) is not ported: the port runs on
one card and takes ``mesh=None`` only (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batched import MAX_EXHAUSTIVE_TABLE_CACHES, masks_to_bits
from repro_torch.device import DeviceLike, resolve_device

# 2^n table rows per version: past this the reference loop is the better
# deal for every provider (single source of truth for the fast engine)
MAX_TABLE_CACHES = 12


# ---------------------------------------------------------------------------
# Plan protocol
# ---------------------------------------------------------------------------

class DecisionPlan:
    """One policy family's replay strategy against a shared SystemTrace."""

    name = "?"

    def matches(self, cfg) -> bool:
        """Whether this plan covers ``cfg`` (policy, subroutine, budget)."""
        raise NotImplementedError

    def selections(self, sim, st) -> torch.Tensor:
        """[N] int64 per-request selection bitmasks on ``st.device`` — the
        committed (post-exploration) cache subset probed for each
        request, bit j = cache j."""
        raise NotImplementedError


class TablePlan(DecisionPlan):
    """A plan whose decisions are a pure (view version, indication
    pattern) function — phase 2 builds ``[V * 2^n]`` selection bitmasks
    on the device, phase 3 is a device gather.  Tables are memoised on
    ``st.plan_cache`` under :meth:`cache_key`."""

    def cache_key(self, cfg) -> tuple:
        """The decision-side configuration the tables depend on."""
        raise NotImplementedError

    def tables(self, sim, st) -> torch.Tensor:
        """[V * 2^n] int64 selection bitmasks on ``st.device``, row
        (v * 2^n + p)."""
        raise NotImplementedError

    def selections(self, sim, st) -> torch.Tensor:
        key = self.cache_key(sim.cfg)
        selm_tab = st.plan_cache.get(key)
        if selm_tab is None:
            selm_tab = self.tables(sim, st)
            st.plan_cache[key] = selm_tab
        d = st.device_arrays()
        return selm_tab[d["ver"] * (1 << st.n) + d["pats"]]      # [N]


# ---------------------------------------------------------------------------
# Built-in providers
# ---------------------------------------------------------------------------

class FnaCalSegmented(DecisionPlan):
    """The calibrated policy: per-probe EWMA state breaks the frozen-view
    invariant, so it replays via the speculate-and-commit segments of
    ``repro_torch.cachesim.fna_cal_fast`` (host NumPy, as in the
    reference); the committed selections then replay on the device."""

    name = "fna_cal"

    def matches(self, cfg) -> bool:
        if cfg.policy != "fna_cal":
            return False
        # the verification pass needs the batched subset enumeration;
        # past its budget the reference loop wins
        return cfg.alg != "exhaustive" or \
            cfg.n_caches <= MAX_EXHAUSTIVE_TABLE_CACHES

    def selections(self, sim, st) -> torch.Tensor:
        from repro_torch.cachesim.fna_cal_fast import fna_cal_selections
        return torch.as_tensor(fna_cal_selections(sim, st),
                               device=st.device)


class PiReplay(DecisionPlan):
    """PI accesses the cheapest cache truly holding x; hash placement
    means only the designated cache can — so membership IS the plan:
    probe the designated cache iff it truly holds x, nothing otherwise."""

    name = "pi"

    def matches(self, cfg) -> bool:
        return cfg.policy == "pi"

    def selections(self, sim, st) -> torch.Tensor:
        d = st.device_arrays()
        return torch.where(d["in_dj"], torch.ones_like(d["dj"]) << d["dj"],
                           torch.zeros_like(d["dj"]))


class HocsTables(TablePlan):
    """Algorithm 1 on pooled homogeneous estimates, via the exact NumPy
    mirror (``repro_torch.core.batched.hocs_selection_tables``); the
    tables do not depend on the (homogeneous) cost level."""

    name = "hocs"

    def matches(self, cfg) -> bool:
        return cfg.policy == "hocs"

    def cache_key(self, cfg) -> tuple:
        return ("hocs", float(cfg.miss_penalty))

    def tables(self, sim, st) -> torch.Tensor:
        from repro_torch.core.batched import hocs_selection_tables
        return torch.as_tensor(hocs_selection_tables(
            st.pi_v, st.nu_v, sim.cfg.miss_penalty).reshape(-1),
            device=st.device)


class DsPgmTables(TablePlan):
    """CS_FNA / CS_FNO with the DS_PGM subroutine — torch float64 on the
    device (exact modulo the ~1e-12 near-tie caveat documented on
    ``repro_torch.core.batched``).  The reference pads V to a power of
    two for XLA's compile cache; eager torch compiles nothing, so the
    port builds exactly V versions."""

    name = "ds_pgm"

    def matches(self, cfg) -> bool:
        return cfg.policy in ("fna", "fno") and cfg.alg == "ds_pgm"

    def cache_key(self, cfg) -> tuple:
        return ("ds_pgm", cfg.policy == "fno", tuple(cfg.costs),
                float(cfg.miss_penalty))

    def tables(self, sim, st) -> torch.Tensor:
        from repro_torch.core.batched import selection_tables
        cfg = sim.cfg
        d = st.device_arrays()
        mask = selection_tables(list(cfg.costs), d["pi"], d["nu"],
                                cfg.miss_penalty, fno=(cfg.policy == "fno"))
        return masks_to_bits(mask).reshape(-1)


class ExhaustiveTables(TablePlan):
    """CS_FNA / CS_FNO with the exact Eq. (10) subroutine — the 2^n-subset
    enumeration through the subset-DP kernel (bit-exact vs the scalar
    loop's operation order), n <= 12 = ``MAX_EXHAUSTIVE_TABLE_CACHES``,
    in one kernel call per table."""

    name = "exhaustive"

    def matches(self, cfg) -> bool:
        return cfg.policy in ("fna", "fno") and cfg.alg == "exhaustive" \
            and cfg.n_caches <= MAX_EXHAUSTIVE_TABLE_CACHES

    def cache_key(self, cfg) -> tuple:
        return ("exhaustive", cfg.policy == "fno", tuple(cfg.costs),
                float(cfg.miss_penalty))

    def tables(self, sim, st) -> torch.Tensor:
        from repro_torch.core.batched import exhaustive_tables
        cfg = sim.cfg
        d = st.device_arrays()
        return exhaustive_tables(list(cfg.costs), d["pi"], d["nu"],
                                 cfg.miss_penalty,
                                 fno=(cfg.policy == "fno")).reshape(-1)


class ScalarTables(TablePlan):
    """Generic fallback: one scalar subroutine call per (version,
    pattern).  No built-in (policy, subroutine) combination reaches it;
    it stays registered as the safety net for externally registered
    scalar subroutines (any ``sim.alg`` without a batched twin)."""

    name = "scalar"

    def matches(self, cfg) -> bool:
        return cfg.policy in ("fna", "fno")

    def cache_key(self, cfg) -> tuple:
        return ("scalar", cfg.alg, cfg.policy == "fno", tuple(cfg.costs),
                float(cfg.miss_penalty))

    def tables(self, sim, st) -> torch.Tensor:
        cfg = sim.cfg
        costs = list(cfg.costs)
        M = cfg.miss_penalty
        n = st.n
        k = 1 << n
        fno = cfg.policy == "fno"
        v_count = st.pi_v.shape[0]
        sel = np.empty(v_count * k, dtype=np.int64)
        for v in range(v_count):
            pi, nu = st.pi_v[v], st.nu_v[v]
            for p in range(k):
                if fno:
                    pos = [j for j in range(n) if (p >> j) & 1]
                    chosen = []
                    if pos:
                        sub = sim.alg([costs[j] for j in pos],
                                      [float(pi[j]) for j in pos], M)
                        chosen = [pos[t] for t in sub]
                else:
                    rhos = [float(pi[j]) if (p >> j) & 1 else float(nu[j])
                            for j in range(n)]
                    chosen = sim.alg(costs, rhos, M)
                m = 0
                for j in chosen:
                    m |= 1 << j
                sel[v * k + p] = m
        return torch.as_tensor(sel, device=st.device)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

#: ordered provider registry — first match wins; the scalar fallback last
PROVIDERS: List[DecisionPlan] = [
    FnaCalSegmented(), PiReplay(), HocsTables(), DsPgmTables(),
    ExhaustiveTables(), ScalarTables(),
]


def register_provider(plan: DecisionPlan, *, index: int = 0) -> None:
    """Install a custom provider (at ``index``, so it can shadow a
    built-in; the scalar fallback should stay last)."""
    PROVIDERS.insert(index, plan)


def plan_for(cfg) -> Optional[DecisionPlan]:
    """The first registered plan covering ``cfg``, or ``None`` when the
    configuration is outside every plan's budget (the simulator falls
    back to the reference loop)."""
    if cfg.n_caches > MAX_TABLE_CACHES:
        return None
    for plan in PROVIDERS:
        if plan.matches(cfg):
            return plan
    return None


# ---------------------------------------------------------------------------
# Cross-cell sharing for decision-side sweep axes
# ---------------------------------------------------------------------------

def table_keys_for(cfgs: Sequence, policies: Sequence[str]):
    """Every distinct ``plan_cache`` key a (cells x policies) panel will
    consult, in first-use order — the preload/flush manifest of the
    artifact store (``repro_torch.cachesim.store``)."""
    keys = []
    seen = set()
    for cfg in cfgs:
        for p in policies:
            pcfg = dataclasses.replace(cfg, policy=p)
            plan = plan_for(pcfg)
            if not isinstance(plan, TablePlan):
                continue
            key = plan.cache_key(pcfg)
            if key not in seen:
                seen.add(key)
                keys.append(key)
    return keys


def check_mesh(mesh) -> None:
    """The port runs a grid on one device: ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: sharding the cell axis over a device mesh is not ported "
            "(ROADMAP A5); the port runs on one device, pass mesh=None")


def _plan_jobs(system, cfgs, policies, plan_cls):
    """Unseeded (cache key, configured pcfg) pairs dispatching to
    ``plan_cls``, deduplicated in first-use order."""
    jobs = []
    seen = set()
    for cfg in cfgs:
        for p in policies:
            pcfg = dataclasses.replace(cfg, policy=p)
            plan = plan_for(pcfg)
            if type(plan) is not plan_cls:
                continue
            key = plan.cache_key(pcfg)
            if key in system.plan_cache or key in seen:
                continue
            seen.add(key)
            jobs.append((key, pcfg))
    return jobs


def _prefetch_exhaustive(system, cfgs, policies) -> None:
    """Stack exhaustive-subroutine table builds across decision cells:
    one kernel pass per (costs, fno) group covers every penalty cell,
    each row carrying its own penalty
    (``repro_torch.core.batched.exhaustive_tables_cells``)."""
    from repro_torch.core.batched import exhaustive_tables_cells
    groups: Dict[tuple, list] = {}
    for key, pcfg in _plan_jobs(system, cfgs, policies, ExhaustiveTables):
        groups.setdefault((tuple(pcfg.costs), pcfg.policy == "fno"),
                          []).append((key, float(pcfg.miss_penalty)))
    d = system.device_arrays() if groups else None
    for (costs, fno), jobs in groups.items():
        if len(jobs) < 2:    # a single build gains nothing from stacking
            continue
        tabs = exhaustive_tables_cells(
            list(costs), d["pi"], d["nu"], [m for _, m in jobs], fno=fno)
        for (key, _), tab in zip(jobs, tabs):
            system.plan_cache[key] = tab.reshape(-1)


def _prefetch_hocs(system, cfgs, policies) -> None:
    """Stack HOCS table builds across decision cells: the pooled
    estimates are penalty-independent, so one
    ``hocs_selection_tables_cells`` call covers every penalty cell."""
    from repro_torch.core.batched import hocs_selection_tables_cells
    jobs = _plan_jobs(system, cfgs, policies, HocsTables)
    if len(jobs) < 2:        # a single build gains nothing from stacking
        return
    tabs = hocs_selection_tables_cells(
        system.pi_v, system.nu_v, [pcfg.miss_penalty for _, pcfg in jobs])
    for (key, _), tab in zip(jobs, tabs):
        system.plan_cache[key] = torch.as_tensor(tab.reshape(-1),
                                                 device=system.device)


def _prefetch_ds_pgm(system, cfgs, policies) -> None:
    """Stack DS_PGM table builds across decision cells into one two-stage
    ``selection_tables_cells`` evaluation (one sort per (costs, fno)
    group, one penalty finish per cell)."""
    from repro_torch.core.batched import selection_tables_cells
    jobs = _plan_jobs(system, cfgs, policies, DsPgmTables)
    if len(jobs) < 2:        # a single build gains nothing from stacking
        return
    d = system.device_arrays()
    masks = selection_tables_cells(
        [tuple(p.costs) for _, p in jobs], d["pi"], d["nu"],
        [float(p.miss_penalty) for _, p in jobs],
        [p.policy == "fno" for _, p in jobs])            # [C, V, 2^n, n]
    for (key, _), mask in zip(jobs, masks):
        system.plan_cache[key] = masks_to_bits(mask).reshape(-1)


def prefetch_tables(system, cfgs: Sequence, policies: Sequence[str]) -> None:
    """Stack every stackable (cell, policy) table build of a decision-side
    group into one batched call per provider family, seeding
    ``system.plan_cache`` so the per-cell replays become pure lookups.
    Row-level independence of each batched builder makes every stacked
    slice bit-identical to the per-cell build it replaces."""
    _prefetch_exhaustive(system, cfgs, policies)
    _prefetch_hocs(system, cfgs, policies)
    _prefetch_ds_pgm(system, cfgs, policies)


@dataclasses.dataclass
class RunReport:
    """What a fast-engine run observed, filled in when the caller passes
    one to :func:`run_cells` / ``run_policies`` / ``Simulator.run``: the
    system sweep it computed (the last one, when runs do not share it) and
    the host seconds of each phase.  Every phase ends at a device sync so
    its seconds include its device work; the syncs happen only when a
    report is asked for.  Per-policy seconds add up across cells."""

    system: Optional[object] = None
    phase1_s: float = 0.0                     # system sweep (+ to device)
    prefetch_s: float = 0.0                   # phase 2's stacked builds
    phase2_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    phase3_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def since(self, t0: float, device: torch.device) -> float:
        """Seconds from ``t0`` to now, after the device's work is done."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    def add(self, phase: str, policy: str, t0: float,
            device: torch.device) -> float:
        """Add the seconds since ``t0`` to ``phase``'s entry for
        ``policy``; returns the current time (the next phase's start)."""
        per_policy = getattr(self, phase)
        per_policy[policy] = per_policy.get(policy, 0.0) + \
            self.since(t0, device)
        return time.perf_counter()


def run_cells(trace: np.ndarray, cfgs: Sequence, policies: Sequence[str],
              share_system: bool = True, *, device: DeviceLike = None,
              mesh=None, store=None, chunk_size: Optional[int] = None,
              spill=None, report: Optional[RunReport] = None) -> List[Dict]:
    """Run a policy panel over several decision-side cells that share one
    system evolution on ``device`` (``None`` -> ``cuda``); returns
    ``[{policy: SimResult}]`` aligned with ``cfgs``.

    On the fast engine with ``share_system=True`` the policy-independent
    system sweep is computed EXACTLY ONCE for the whole group (all cells
    must share ``SystemTrace.system_key``) and every stackable table
    build is prefetched in one batched call per provider family.
    ``share_system=False`` forces independent full runs; the reference
    engine always runs full.  ``chunk_size``/``spill`` stream phase 1
    (bit-identity-preserving, see ``SystemTrace.compute``).  ``report``
    (optional) receives the sweep and the phase times (a stored sweep's
    load counts as phase 1).

    ``store`` (an ``ArtifactStore``, a root path, or None) consults the
    content-addressed artifact store before the sweep: a hit hydrates the
    stored ``SystemTrace`` onto ``device`` (bit-identical replay) instead
    of computing, a miss computes and persists it.  Decision tables
    stored for ``device``'s type are preloaded onto it, and any freshly
    built ones are saved after the replays — keyed on the device type, so
    a card-built table never serves a CPU run, nor the other way round.

    ``mesh`` must be None: the reference's sharding of the cell axis over
    a device mesh is not ported (the port runs on one device).
    """
    from repro_torch.cachesim.simulator import Simulator
    from repro_torch.cachesim.store import as_store
    from repro_torch.cachesim.systemstate import SystemTrace
    check_mesh(mesh)
    device = resolve_device(device)
    trace = np.asarray(trace, dtype=np.uint64)
    out: List[Dict] = [dict() for _ in cfgs]
    system = None
    share = share_system and bool(cfgs) and trace.shape[0] > 0 and \
        all(cfg.engine == "fast" for cfg in cfgs)
    store = as_store(store) if share else None
    digest = None
    preloaded = set()
    if share and any(plan_for(dataclasses.replace(cfg, policy=p)) is not None
                     for cfg in cfgs for p in policies):
        t0 = time.perf_counter()
        sys_key = SystemTrace.system_key(cfgs[0])
        if store is not None:
            digest = store.trace_digest(trace)
            system = store.load_sweep(trace, sys_key, device=device,
                                      trace_digest=digest)
        if system is None:
            system = SystemTrace.compute(Simulator(cfgs[0], device), trace,
                                         chunk_size=chunk_size, spill=spill)
            if store is not None:
                store.save_sweep(system, trace_digest=digest)
        system.device_arrays()
        if report is not None:
            report.system = system
            report.phase1_s += report.since(t0, device)
            t0 = time.perf_counter()
        if store is not None:
            for key in table_keys_for(cfgs, policies):
                tab = store.load_table(digest, sys_key, key, device)
                if tab is not None:
                    system.plan_cache[key] = tab
                    preloaded.add(key)
        prefetch_tables(system, cfgs, policies)
        if report is not None:
            report.prefetch_s += report.since(t0, device)
    for ci, cfg in enumerate(cfgs):
        for p in policies:
            sim = Simulator(dataclasses.replace(cfg, policy=p), device)
            out[ci][p] = sim.run(trace,
                                 system=system if share_system else None,
                                 chunk_size=chunk_size, report=report)
            if share_system and system is None:
                system = getattr(sim, "last_system", None)
    # save the tables built this run (prefetched or replay-built) so the
    # next warm run starts with every lookup already on disk
    if store is not None and digest is not None:
        for key, tab in system.plan_cache.items():
            if key not in preloaded:
                store.save_table(digest, system.key, key, tab)
    return out
