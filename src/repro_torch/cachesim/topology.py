"""Hierarchical cache topologies: composable tier nodes (paper Sec. V
system, recursed icarus-style over PATH and TREE hierarchies) — the port
of the JAX package's ``repro.cachesim.topology``, on one torch device.

The flat simulator models ONE hop: a client in front of n parallel
caches with indicators.  Real indicator deployments are hierarchies —
an edge tier's misses recurse to a parent tier with its own indicator
staleness and false-negative regime (ROADMAP item 3; networks-of-caches
per arXiv:1202.4880).  This module composes the UNCHANGED one-hop
engine into such hierarchies:

  * a :class:`TierSystem` is one hop — n caches + indicators + advert
    policies + a decision provider, i.e. exactly the system the flat
    engine simulates, plus the per-tier knobs of :class:`TierSpec`
    (hop penalty, service latency, admission queue);
  * a :class:`TopoConfig` arranges tier nodes into a PATH (depth d
    chains of single nodes) or a TREE (``fanout`` children per parent,
    leaves at level 0, root at level ``depth - 1``);
  * a miss at depth d re-enters the identical engine at depth d + 1:
    the parent's arrival stream is the merge (in trace order) of its
    children's residency-miss subsequences, and the parent node runs
    the same phase-1 sweep / decision plan / replay stack on it.

RESIDENCY-DRIVEN RECURSION.  Hash-designated placement means a key can
only reside in its designated cache, so "miss at tier d" — not resident
in the designated cache — is a property of the SYSTEM evolution, never
of the policy under test.  Consequently every tier's arrival stream,
and with it every tier's :class:`~repro_torch.cachesim.systemstate.
SystemTrace`, is policy-independent: the fair-comparison property of
the flat engine survives composition, one sweep per tier node serves
the whole policy panel, and the per-tier sweeps are content-addressed
in the :class:`~repro_torch.cachesim.store.ArtifactStore` (schema v3) under
(tier arrival stream digest, tier system key) — reusable across
topology cells and even across DEPTHS, because tier d's stream does not
depend on how many tiers sit behind it.

ACCOUNTING (identical code for both engines; the per-request
observables come from the fast sweep + decision plans or from the
recording reference loop):

  * cost   = sum of probe costs at every visited tier (admitted
    arrivals only) + ``hop_penalty[d]`` for every d -> d+1 forward +
    ``origin_penalty`` when no visited tier served the request.  A
    depth-1 path with zero hop knobs degenerates BIT-IDENTICALLY to the
    flat engine's ``probe + miss_penalty`` accounting (the empty
    selection costs exactly ``0.0`` and ``0.0 + M == M``; the scalar
    fold order is the flat engine's trace order).
  * latency = sum of ``tier_latency[d]`` over visited tiers +
    ``origin_latency`` when unserved (kept separate from cost — the
    mean-latency metric of the topo scenario family).
  * rejection: a deterministic admission window per tier
    (``queue_capacity`` admitted out of every ``queue_window``
    arrivals; 0 disables).  Rejected arrivals probe nothing and cannot
    be served by that tier, but the SYSTEM evolution and the forwarding
    stream stay residency-driven — the queue is a service-time overlay,
    so sweeps remain shareable and policy-independent.

Engine parity: the fast path replays each tier through
``DecisionPlan.selections`` and the reference path records the same
per-request observables from the oracle loop
(``Simulator._run_reference(record=...)``); tier-by-tier selection
parity is exactly the flat engines' bit-exactness, so topology results
are pinned fast == reference in the golden suite
(``topo_path`` / ``topo_tree`` scenarios).

DEVICE.  Every tier's decision plan runs on the run's device (tables on
the card, the exhaustive ones through the subset-DP kernel), and its
selections come back to the host ONCE per (tier, policy)
(:meth:`TierSystem.selections`).  The accounting fold stays the host
NumPy of the reference, in the reference's order: the float64 cost and
latency folds are what the golden files pin bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cachesim.simulator import SimConfig, SimResult, Simulator
from repro_torch.cachesim.systemstate import SystemTrace
from repro_torch.device import DeviceLike, resolve_device

#: per-tier knob names a tier mapping may carry besides SimConfig fields
TIER_KEYS = ("hop_penalty", "tier_latency", "queue_capacity",
             "queue_window")

_QUALITY_KEYS = ("fn_events", "fn_opportunities", "fp_events",
                 "fp_opportunities", "resident")

#: multiplicative-hash constant for leaf assignment (golden ratio);
#: deliberately unrelated to the designated-cache ``key % n`` hash
_EDGE_HASH = np.uint64(0x9E3779B97F4A7C15)

_EMPTY_POS = np.empty(0, dtype=np.int64)


def edge_assignment(keys: np.ndarray, n_leaves: int) -> np.ndarray:
    """Deterministic leaf index per request key for TREE topologies —
    a multiplicative hash, independent of the in-tier designated-cache
    hash so leaf routing does not correlate with cache designation."""
    h = np.asarray(keys, np.uint64) * _EDGE_HASH
    return ((h >> np.uint64(33)) % np.uint64(n_leaves)).astype(np.int64)


@dataclass(frozen=True)
class TierSpec:
    """The per-tier knobs that live OUTSIDE the one-hop system: what a
    visit costs beyond the probes, and whether the tier admits the
    arrival at all."""
    hop_penalty: float = 0.0     # cost of forwarding from this tier to
    #                              the next (applied to residency misses
    #                              of every non-last tier)
    tier_latency: float = 0.0    # service latency per visit (latency
    #                              metric only — never enters cost)
    queue_capacity: int = 0      # arrivals admitted per window; 0 = off
    queue_window: int = 0        # admission window length; 0 = off

    def admitted(self, m: int) -> np.ndarray:
        """[m] bool admission mask over a tier's arrival sequence: the
        first ``queue_capacity`` of every ``queue_window`` consecutive
        arrivals are admitted — deterministic and policy-independent,
        so the overlay never splits sweep sharing."""
        if self.queue_capacity <= 0 or self.queue_window <= 0 or \
                self.queue_capacity >= self.queue_window:
            return np.ones(m, dtype=bool)
        return (np.arange(m, dtype=np.int64) % self.queue_window) \
            < self.queue_capacity


@dataclass(frozen=True)
class TopoConfig:
    """A PATH or TREE of tier nodes over one base :class:`SimConfig`.

    ``tiers`` holds one mapping per depth (missing / extra entries are
    fine — deeper-than-``depth`` specs are simply unused, so a depth
    axis can sweep below a fully specified tier list).  Each mapping
    mixes SimConfig overrides (per-tier cache sizes, advertisement
    cadences, ...) with the :data:`TIER_KEYS` knobs of
    :class:`TierSpec`.  ``origin_penalty`` defaults to the base config's
    ``miss_penalty`` — which is what makes depth 1 with zero hop knobs
    the flat engine, bit for bit."""
    base: SimConfig
    kind: str = "path"                   # path | tree
    depth: int = 1
    fanout: int = 2                      # children per parent (tree)
    tiers: Tuple[Mapping, ...] = ()      # per-depth overrides + knobs
    origin_penalty: Optional[float] = None   # None -> base.miss_penalty
    origin_latency: float = 0.0

    def __post_init__(self):
        if self.kind not in ("path", "tree"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        if not isinstance(self.depth, int) or self.depth < 1:
            raise ValueError(f"depth must be an int >= 1, got "
                             f"{self.depth!r}")
        if self.kind == "tree" and (not isinstance(self.fanout, int)
                                    or self.fanout < 1):
            raise ValueError(f"fanout must be an int >= 1, got "
                             f"{self.fanout!r}")
        object.__setattr__(self, "tiers",
                           tuple(dict(t) for t in self.tiers))
        sim_fields = set(SimConfig.__dataclass_fields__)
        for d, t in enumerate(self.tiers):
            bad = [k for k in t if k not in sim_fields
                   and k not in TIER_KEYS]
            if bad:
                raise ValueError(
                    f"tier {d} override {bad[0]!r} is neither a "
                    f"SimConfig field nor a tier knob {TIER_KEYS}")

    # -- composition geometry ---------------------------------------------

    @property
    def seed(self) -> int:
        """The base seed (``run_grid`` trace generation reads it)."""
        return self.base.seed

    def level_width(self, d: int) -> int:
        """Node count at depth ``d``: 1 on a path; ``fanout^(depth-1-d)``
        on a tree (leaves at 0, root at ``depth - 1``)."""
        if self.kind == "path":
            return 1
        return self.fanout ** (self.depth - 1 - d)

    def tier_mapping(self, d: int) -> Mapping:
        return self.tiers[d] if d < len(self.tiers) else {}

    def tier_spec(self, d: int) -> TierSpec:
        t = self.tier_mapping(d)
        return TierSpec(
            hop_penalty=float(t.get("hop_penalty", 0.0)),
            tier_latency=float(t.get("tier_latency", 0.0)),
            queue_capacity=int(t.get("queue_capacity", 0)),
            queue_window=int(t.get("queue_window", 0)))

    def node_config(self, d: int, i: int = 0) -> SimConfig:
        """The SimConfig of node ``i`` at depth ``d``: base + tier
        overrides + a node-unique seed offset (zero at the (0, 0) node,
        so a depth-1 path IS the flat system)."""
        over = {k: v for k, v in self.tier_mapping(d).items()
                if k not in TIER_KEYS}
        cfg = dataclasses.replace(self.base, **over) if over else self.base
        off = d * 1_000_003 + i * 7_919
        return dataclasses.replace(cfg, seed=cfg.seed + off) if off else cfg

    def origin_penalty_value(self) -> float:
        return float(self.base.miss_penalty
                     if self.origin_penalty is None
                     else self.origin_penalty)


#: axis-override keys routed to the TopoConfig itself (vs tiers / base)
_TOPO_FIELDS = frozenset(
    k for k in TopoConfig.__dataclass_fields__ if k != "base")


def topo_cell(base: TopoConfig, overrides: Mapping) -> TopoConfig:
    """Apply one grid cell's overrides to a topology config, routing
    each key by kind: TopoConfig fields (``depth``, ``fanout``,
    ``origin_penalty``, ...) replace on the topology; :data:`TIER_KEYS`
    broadcast into every tier mapping (a scalar) or distribute per tier
    (a sequence of length ``depth``); anything else is a SimConfig
    override on the shared base — propagating to every tier that does
    not itself override the same field."""
    topo_kw, tier_kw, sim_kw = {}, {}, {}
    for k, v in overrides.items():
        if k in _TOPO_FIELDS:
            topo_kw[k] = v
        elif k in TIER_KEYS:
            tier_kw[k] = v
        else:
            sim_kw[k] = v
    out = base
    if sim_kw:
        out = dataclasses.replace(
            out, base=dataclasses.replace(out.base, **sim_kw))
    if topo_kw:
        out = dataclasses.replace(out, **topo_kw)
    if tier_kw:
        depth = out.depth
        tiers = [dict(out.tier_mapping(d)) for d in range(depth)]
        for k, v in tier_kw.items():
            if isinstance(v, (list, tuple)):
                if len(v) != depth:
                    raise ValueError(
                        f"per-tier override {k}={v!r} has length "
                        f"{len(v)}, expected depth={depth}")
                for d in range(depth):
                    tiers[d][k] = v[d]
            else:
                for d in range(depth):
                    tiers[d][k] = v
        out = dataclasses.replace(out, tiers=tuple(tiers))
    return out


# ---------------------------------------------------------------------------
# One hop
# ---------------------------------------------------------------------------

class TierSystem:
    """One hop of a hierarchy: the flat engine's system (n caches +
    indicators + advert policies) plus its decision provider, behind the
    two calls composition needs — a policy-independent sweep of the
    tier's arrival stream, and per-policy selection bitmasks against it.
    A depth-1 path holds exactly one of these, configured identically to
    the flat simulator.  ``device`` is where its decision plans run."""

    def __init__(self, cfg: SimConfig, spec: TierSpec,
                 depth: int = 0, index: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.spec = spec
        self.depth = depth
        self.index = index
        self.device = resolve_device(device)

    @property
    def costs(self) -> list:
        return [float(c) for c in self.cfg.costs]

    def sweep(self, keys: np.ndarray,
              chunk_size: Optional[int] = None) -> SystemTrace:
        """Phase 1 for this tier: the flat sweep over the tier's own
        arrival stream (callers normally go through :class:`SweepPool`
        for in-memory + store-backed reuse)."""
        return SystemTrace.compute(Simulator(self.cfg, self.device),
                                   np.asarray(keys, np.uint64),
                                   chunk_size=chunk_size)

    def selections(self, st: SystemTrace, policy: str) -> np.ndarray:
        """[m] committed per-arrival selection bitmasks for ``policy``
        at this tier (fast engine), on the host: the decision-plan
        registry of ``repro_torch.cachesim.engine`` on ``st.device``, its
        selections copied to the host once, or — beyond every plan's table
        budget — the recording reference loop on the same stream."""
        from repro_torch.cachesim.engine import plan_for
        pcfg = dataclasses.replace(self.cfg, policy=policy)
        plan = plan_for(pcfg)
        if plan is None:
            rec, _ = self.reference_run(st._trace, policy)
            return rec["selm"]
        selm = plan.selections(Simulator(pcfg, st.device), st)
        return selm.cpu().numpy()

    def reference_run(self, keys: np.ndarray,
                      policy: str) -> Tuple[dict, SimResult]:
        """The oracle loop on this tier's stream, recording the
        per-arrival observables the topology accounting consumes."""
        pcfg = dataclasses.replace(self.cfg, policy=policy,
                                   engine="reference")
        rec: dict = {}
        res = SimResult(policy=policy)
        Simulator(pcfg, self.device)._run_reference(
            np.asarray(keys, np.uint64), res, record=rec)
        return rec, res


class SweepPool:
    """Cross-cell reuse of per-tier sweeps AND per-(tier, policy)
    selections, keyed by (arrival-stream digest, system key) — the same
    content addressing as the :class:`~repro_torch.cachesim.store.
    ArtifactStore`, which backs the pool when given.  One pool shared
    across a topology grid's cells realises the cross-tier sweep
    sharing: a depth axis recomputes nothing for the tiers it already
    visited at smaller depths, and decision-side topology axes (hop
    penalties, origin penalty, queues) reuse both sweeps and
    selections.  The pool's sweeps live on ``device``."""

    def __init__(self, store=None, chunk_size: Optional[int] = None,
                 device: DeviceLike = None):
        from repro_torch.cachesim.store import as_store
        self.store = as_store(store)
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        self._sweeps: Dict[tuple, SystemTrace] = {}
        self._selm: Dict[tuple, np.ndarray] = {}

    def sweep(self, tier: TierSystem, keys: np.ndarray,
              ) -> Optional[SystemTrace]:
        """The tier's SystemTrace over ``keys`` (None for an empty
        stream): in-memory first, then the store, then computed (and
        persisted when a store is attached)."""
        from repro_torch.cachesim.store import ArtifactStore
        keys = np.ascontiguousarray(keys, np.uint64)
        if keys.shape[0] == 0:
            return None
        digest = ArtifactStore.trace_digest(keys)
        k = (digest, SystemTrace.system_key(tier.cfg))
        st = self._sweeps.get(k)
        if st is None and self.store is not None:
            st = self.store.load_sweep(keys, k[1], device=self.device,
                                       trace_digest=digest)
        if st is None:
            st = tier.sweep(keys, chunk_size=self.chunk_size)
            if self.store is not None:
                self.store.save_sweep(st, trace_digest=digest)
        self._sweeps[k] = st
        return st

    def selections(self, tier: TierSystem, st: SystemTrace,
                   policy: str) -> np.ndarray:
        """Memoised :meth:`TierSystem.selections` — the decision-side
        key covers everything a plan's output depends on, so topology
        axes that only move hop/queue/origin knobs replay for free."""
        cfg = tier.cfg
        key = (id(st), policy, cfg.alg,
               tuple(float(c) for c in cfg.costs),
               float(cfg.miss_penalty), float(cfg.cal_gamma),
               int(cfg.cal_min_obs), float(cfg.cal_epsilon),
               int(cfg.seed))
        selm = self._selm.get(key)
        if selm is None:
            selm = tier.selections(st, policy)
            self._selm[key] = selm
        return selm


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class TopoResult:
    """Per-policy result of one topology run.  The first eleven fields
    mirror :class:`~repro_torch.cachesim.simulator.SimResult` (and equal it
    bit-for-bit on a knob-free depth-1 path); the rest are the
    hierarchy metrics.  Per-level fields are plain lists so the golden
    JSON round-trip compares equal."""
    policy: str
    n_requests: int = 0
    total_cost: float = 0.0
    hits: int = 0
    pos_accesses: int = 0
    neg_accesses: int = 0
    fn_events: int = 0
    fn_opportunities: int = 0
    fp_events: int = 0
    fp_opportunities: int = 0
    resident: int = 0
    total_latency: float = 0.0
    rejected: int = 0
    origin_fetches: int = 0
    tier_arrivals: List[int] = field(default_factory=list)
    tier_hits: List[int] = field(default_factory=list)
    tier_rejected: List[int] = field(default_factory=list)

    @property
    def mean_cost(self) -> float:
        return self.total_cost / max(self.n_requests, 1)

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(self.n_requests, 1)

    @property
    def fn_ratio(self) -> float:
        return self.fn_events / max(self.fn_opportunities, 1)

    @property
    def fp_ratio(self) -> float:
        return self.fp_events / max(self.fp_opportunities, 1)

    @property
    def mean_latency(self) -> float:
        return self.total_latency / max(self.n_requests, 1)

    @property
    def rejection_rate(self) -> float:
        """Fraction of tier arrivals the admission queues rejected."""
        return self.rejected / max(sum(self.tier_arrivals), 1)

    def to_dict(self) -> Dict:
        return {
            "policy": self.policy, "n": self.n_requests,
            "mean_cost": round(self.mean_cost, 4),
            "hit_ratio": round(self.hit_ratio, 4),
            "fn_ratio": round(self.fn_ratio, 5),
            "fp_ratio": round(self.fp_ratio, 5),
            "pos_accesses": self.pos_accesses,
            "neg_accesses": self.neg_accesses,
            "mean_latency": round(self.mean_latency, 4),
            "rejection_rate": round(self.rejection_rate, 5),
            "origin_fetches": self.origin_fetches,
        }


# ---------------------------------------------------------------------------
# Composition + accounting
# ---------------------------------------------------------------------------

def _edge_streams(topo: TopoConfig, trace: np.ndarray) -> List[np.ndarray]:
    """Level-0 arrival positions per node (trace positions)."""
    n0 = topo.level_width(0)
    if n0 == 1:
        return [np.arange(trace.shape[0], dtype=np.int64)]
    leaf = edge_assignment(trace, n0)
    return [np.flatnonzero(leaf == e).astype(np.int64) for e in range(n0)]


def _merge_to_parents(miss_pos: List[np.ndarray],
                      group: int) -> List[np.ndarray]:
    """Parent arrival positions: each parent receives the merge — in
    original trace order — of its ``group`` children's residency-miss
    subsequences."""
    out = []
    for p in range(len(miss_pos) // group):
        parts = miss_pos[p * group:(p + 1) * group]
        out.append(np.sort(np.concatenate(parts)) if group > 1
                   else parts[0])
    return out


def _advert_totals(st: SystemTrace) -> Tuple[int, float]:
    nodes = st.final_state["nodes"]
    return (sum(len(nd["adv_ins"]) for nd in nodes),
            sum(b for nd in nodes for b in nd["adv_bytes"]))


def _accumulate_topology(topo: TopoConfig, n_client: int, policy: str,
                         node_rows: List[dict]) -> TopoResult:
    """Fold per-tier observables into a :class:`TopoResult` — the ONE
    accounting implementation both engines share.  ``node_rows`` carry,
    per non-empty node: depth, trace positions, selection bitmasks,
    designated-cache residency/index, indication patterns, probe costs,
    sweep quality counters and advert totals."""
    res = TopoResult(policy=policy, n_requests=n_client)
    depth = topo.depth
    res.tier_arrivals = [0] * depth
    res.tier_hits = [0] * depth
    res.tier_rejected = [0] * depth
    cost = np.zeros(n_client, np.float64)
    lat = np.zeros(n_client, np.float64)
    served = np.zeros(n_client, dtype=bool)
    adv_events, adv_bytes = 0, 0.0
    for row in node_rows:
        d = row["depth"]
        spec = topo.tier_spec(d)
        pos = row["pos"]
        m = int(pos.shape[0])
        if m == 0:
            continue
        selm, in_dj, dj, pats = (row["selm"], row["in_dj"], row["dj"],
                                 row["pats"])
        costs = row["costs"]
        n = len(costs)
        k = 1 << n
        acc_by_mask = np.asarray(
            [sum(costs[j] for j in range(n) if (mk >> j) & 1)
             for mk in range(k)], np.float64)
        popcount = np.asarray([bin(mk).count("1") for mk in range(k)],
                              np.int64)
        admitted = spec.admitted(m)
        sel_eff = np.where(admitted, selm, np.int64(0))
        res.tier_arrivals[d] += m
        n_rej = m - int(np.count_nonzero(admitted))
        res.tier_rejected[d] += n_rej
        res.rejected += n_rej
        cost[pos] += acc_by_mask[sel_eff]
        if spec.tier_latency:
            lat[pos] += spec.tier_latency
        hit = admitted & in_dj & (((sel_eff >> dj) & 1) != 0)
        served[pos[hit]] = True
        nh = int(np.count_nonzero(hit))
        res.tier_hits[d] += nh
        res.hits += nh
        pos_acc = int(popcount[sel_eff & pats].sum())
        res.pos_accesses += pos_acc
        res.neg_accesses += int(popcount[sel_eff].sum()) - pos_acc
        if d + 1 < depth and spec.hop_penalty:
            cost[pos[~in_dj]] += spec.hop_penalty
        for q in _QUALITY_KEYS:
            setattr(res, q, getattr(res, q) + row["quality"][q])
        adv_events += row["advert"][0]
        adv_bytes += row["advert"][1]
    unserved = ~served
    res.origin_fetches = int(np.count_nonzero(unserved))
    cost[unserved] += topo.origin_penalty_value()
    if topo.origin_latency:
        lat[unserved] += topo.origin_latency
    # scalar folds in trace order: bit-exact across engines, and — on a
    # knob-free depth-1 path — identical to the flat engine's fold
    total = 0.0
    for c in cost.tolist():
        total += c
    res.total_cost = total
    total = 0.0
    for c in lat.tolist():
        total += c
    res.total_latency = total
    # advert totals ride as plain attributes, mirroring SimResult
    res.advert_events = adv_events
    res.advert_bytes = adv_bytes
    return res


def _grow_levels(topo: TopoConfig, trace: np.ndarray, pool: SweepPool):
    """Fast-engine composition: sweep every tier node level by level,
    deriving each parent stream from its children's (policy-independent)
    residency misses.  Returns ``[[(tier, pos, st or None)]]``."""
    levels = []
    cur = _edge_streams(topo, trace)
    for d in range(topo.depth):
        row = []
        for i, pos in enumerate(cur):
            tier = TierSystem(topo.node_config(d, i), topo.tier_spec(d),
                              depth=d, index=i, device=pool.device)
            st = pool.sweep(tier, trace[pos]) if pos.shape[0] else None
            row.append((tier, pos, st))
        levels.append(row)
        if d + 1 < topo.depth:
            miss = [pos[st.forward_positions()] if st is not None
                    else _EMPTY_POS for _, pos, st in row]
            cur = _merge_to_parents(
                miss, topo.fanout if topo.kind == "tree" else 1)
    return levels


def run_topology(trace: np.ndarray, topo: TopoConfig,
                 policies: Sequence[str] = ("fna", "fna_cal", "fno", "pi"),
                 *, store=None, chunk_size: Optional[int] = None,
                 pool: Optional[SweepPool] = None,
                 device: DeviceLike = None,
                 ) -> Dict[str, TopoResult]:
    """Run a policy panel over one topology cell on ``device`` (``None``
    -> ``cuda``, raising without a GPU); returns ``{policy: TopoResult}``.

    ``topo.base.engine`` selects the per-tier engine: ``"fast"`` sweeps
    each tier once (via ``pool`` — pass one shared pool on the same
    device to amortise across cells, or let a fresh call-scoped pool back
    onto ``store``) and replays every policy through
    ``DecisionPlan.selections``; ``"reference"`` runs the recording
    oracle loop per (tier, policy).  Both feed the same accounting, so
    results are bit-identical."""
    device = resolve_device(device)
    if pool is not None and pool.device != device:
        raise ValueError(f"the sweep pool lives on {pool.device}, the run "
                         f"on {device}")
    trace = np.ascontiguousarray(trace, np.uint64)
    N = int(trace.shape[0])
    engine = topo.base.engine
    if engine not in ("fast", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    out: Dict[str, TopoResult] = {}
    if engine == "fast":
        if pool is None:
            pool = SweepPool(store, chunk_size, device)
        levels = _grow_levels(topo, trace, pool)
        for policy in policies:
            rows = []
            for d, row in enumerate(levels):
                for tier, pos, st in row:
                    if st is None:
                        continue
                    rows.append({
                        "depth": d, "pos": pos,
                        "selm": pool.selections(tier, st, policy),
                        "in_dj": st.in_dj, "dj": st.dj_all,
                        "pats": st.pats, "costs": tier.costs,
                        "quality": st.quality,
                        "advert": _advert_totals(st)})
            out[policy] = _accumulate_topology(topo, N, policy, rows)
        return out
    for policy in policies:
        rows = []
        cur = _edge_streams(topo, trace)
        for d in range(topo.depth):
            miss = []
            for i, pos in enumerate(cur):
                if pos.shape[0] == 0:
                    miss.append(_EMPTY_POS)
                    continue
                tier = TierSystem(topo.node_config(d, i),
                                  topo.tier_spec(d), depth=d, index=i,
                                  device=device)
                rec, rres = tier.reference_run(trace[pos], policy)
                rows.append({
                    "depth": d, "pos": pos, "selm": rec["selm"],
                    "in_dj": rec["in_dj"], "dj": rec["dj"],
                    "pats": rec["pats"], "costs": tier.costs,
                    "quality": {q: getattr(rres, q)
                                for q in _QUALITY_KEYS},
                    "advert": (rres.advert_events, rres.advert_bytes)})
                miss.append(pos[~rec["in_dj"]])
            if d + 1 < topo.depth:
                cur = _merge_to_parents(
                    miss, topo.fanout if topo.kind == "tree" else 1)
        out[policy] = _accumulate_topology(topo, N, policy, rows)
    return out


def run_topo_grid(traces: Mapping[str, np.ndarray], base: TopoConfig,
                  axis: str, values: Sequence,
                  policies: Sequence[str] = ("fna", "fna_cal", "fno",
                                             "pi"),
                  share_system: bool = True, store=None,
                  chunk_size: Optional[int] = None,
                  device: DeviceLike = None,
                  ) -> Dict[tuple, Dict[str, TopoResult]]:
    """Topology grids for ``run_grid``: sweep a topology axis (``depth``,
    ``fanout``, per-tier ``hop_penalty``/``tier_latency``/queue knobs,
    ``origin_penalty``) or any SimConfig field (broadcast through the
    base into every tier), returning ``{(trace, label): {policy:
    TopoResult}}`` in the caller's cell order, on ``device`` (``None`` ->
    ``cuda``, raising without a GPU).

    ``share_system=True`` shares ONE :class:`SweepPool` (backed by
    ``store`` when given) per trace across all cells: tier sweeps — and,
    for decision-side topology axes, per-tier selections — are computed
    once per distinct (stream, system key) no matter how many cells or
    depths consume them.  ``share_system=False`` gives every cell a
    fresh, store-less pool (benchmarking the amortisation itself).  The
    reference engine always runs the full per-tier oracle loops."""
    from repro_torch.cachesim.sweep import cell_label, cell_overrides
    device = resolve_device(device)
    out: Dict[tuple, Dict[str, TopoResult]] = {}
    for name, trace in traces.items():
        pool = (SweepPool(store, chunk_size, device)
                if share_system and base.base.engine == "fast" else None)
        for value in values:
            key = (name, cell_label(axis, value))
            if key in out:
                raise ValueError(
                    f"duplicate grid cell {key!r}: two axis values "
                    f"share the label {key[1]!r}")
            topo = topo_cell(base, cell_overrides(axis, value))
            out[key] = run_topology(
                trace, topo, policies,
                store=store if share_system else None,
                chunk_size=chunk_size, pool=pool, device=device)
    return out
