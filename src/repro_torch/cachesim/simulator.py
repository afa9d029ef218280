"""Trace-driven multi-cache simulator (paper Sec. V) — the port of the JAX
package's ``repro.cachesim.simulator``.

A :class:`Simulator` runs on a torch device (``device=None`` is ``cuda``,
and raises without a GPU; pass ``"cpu"`` deliberately).  Phase 1 and the
reference loop are NumPy/Python as in the reference; the fast engine's
decision tables and replay gathers run on the device (``engine.py``,
``fastpath.py``), the exhaustive tables through the hand-written
subset-DP kernel.

System model:
  * n caches (LRU) with sizes C_j and access costs c_j; miss penalty M.
  * the controller places each (missed) item in a single designated cache,
    chosen by hashing the key — the load-balancing/content-maximising
    policy of Sec. V-A ("a missed item is placed in a single cache chosen
    by the controller"), which also makes cache dynamics identical across
    access policies (fair comparison).
  * each cache keeps a CBF for bookkeeping, advertises a compressed bitmap
    every ``update_interval`` insertions, and re-estimates (FP, FN) via
    Eqs. (7)-(8) every ``est_interval`` insertions.
  * the client runs CS_FNA / CS_FNO (Algorithm 2) with per-cache EWMA
    q-estimates (Eq. 9), or the PI lower bound.

Every request pays sum(c_j for j accessed) + M if no accessed cache holds
the item (the realised service cost; its mean is the paper's metric).

Engines
-------
``SimConfig.engine`` selects between two bit-exact implementations:

  * ``"reference"`` — the per-request scalar loop (the oracle).
  * ``"fast"``      — the shared-SystemTrace architecture: a
    policy-independent system sweep (``repro_torch.cachesim.systemstate``)
    feeding per-policy replays (``repro_torch.cachesim.fastpath`` for the
    model-based policies, ``repro_torch.cachesim.fna_cal_fast`` for the
    calibrated one).

The fast architecture rests on one structural fact and two exact
invariants:

  S (shared system state): the controller places every missed request in
     its hash-designated cache, so the SYSTEM state — LRU contents, CBF
     counters, stale bitmaps, Eq. 7-8 estimates, Eq. 9 q-estimates — is
     the same for every policy.  Phase 1 therefore runs ONCE per (trace,
     system config) as a :class:`~repro_torch.cachesim.systemstate.SystemTrace`
     and is reused across policies: :func:`run_policies` and
     ``repro_torch.cachesim.engine.run_cells`` pay one sweep plus a cheap
     replay per policy.

  I1 (advertisement epochs): the client-visible STALE bitmaps only change
     when a cache advertises, which happens after ``update_interval``
     insertions into that cache.  Between two advertisement boundaries the
     indication I_j(x) of every request is a pure function of the frozen
     bitmap, so indications for a whole epoch slice are computed in one
     vectorised reduction over the precomputed hash indices.

  I2 (view versions): the client-side views (pi_j, nu_j) only move when
     ``(node.version, q_est.version)`` bumps — i.e. at FP/FN re-estimation
     (every ``est_interval`` insertions), at advertisements, and at
     q-epoch boundaries (every ``q_horizon`` requests).  Between bumps a
     model-based policy's decision depends on the request ONLY through the
     n-bit indication pattern, so there are at most 2^n distinct
     selections per view version; the fast engine memoises the full
     decision table per version (via the batched torch ``ds_pgm_batched``
     path or the subset-DP kernel) and turns per-request policy calls into
     table lookups.

``fna_cal`` breaks I2 (its empirical EWMAs move on every probe outcome),
but its decisions still change only when a drifting rho crosses a DS_PGM
decision boundary, so it replays in speculate-and-commit segments —
frozen decision tables, exact batched EWMA trajectories, and a batched
float64 verification pass per segment (``repro_torch.cachesim.fna_cal_fast``).
Everything else (LRU dynamics, CBF bookkeeping cadence, Eq. 7-9 updates,
cost accounting order) is replicated operation-for-operation, so the two
engines produce identical ``SimResult``s for every policy.  Both
subroutines run fast: DS_PGM through the batched prefix scan, exhaustive
through a batched 2^n-subset enumeration (chunked, bit-exact DP over
subset masks, n <= 12 like every table plan).  The only remaining
reference-engine fallback is cache counts beyond the table budget
(n > 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import (
    QEstimator,
    ds_pgm,
    exhaustive,
    hash_indices,
    optimal_k,
    perfect_information,
)
from repro_torch.core.indicator import StaleIndicatorPair
from repro_torch.cachesim import advert as _adv
from repro_torch.cachesim.lru import LRUCache
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class SimConfig:
    n_caches: int = 3
    # cache_size / bpe / update_interval / est_interval accept either one
    # scalar (every cache identical — the paper's Figs. 4-7 setups) or a
    # per-cache sequence of length n_caches (heterogeneous tiers, staggered
    # advertisement cadences, delayed-view caches; scenario regimes beyond
    # the paper).  ``cache_sizes``/``bpes``/``update_intervals``/
    # ``est_intervals`` expose the normalised per-cache tuples.
    cache_size: Union[int, Sequence[int]] = 10_000
    costs: Sequence[float] = (1.0, 2.0, 3.0)
    miss_penalty: float = 100.0
    bpe: Union[float, Sequence[float]] = 14.0
    update_interval: Union[int, Sequence[int]] = 1_000
    # ^ insertions between advertisements
    est_interval: Union[int, Sequence[int]] = 50
    # ^ insertions between FP/FN re-estimation
    # --- advertisement-event subsystem (repro_torch.cachesim.advert; arXiv:
    # 2104.01386 / 2405.17801).  All five accept a scalar or a per-cache
    # sequence; ``advert_policies``/... expose the normalised tuples and
    # ``repro_torch.cachesim.advert.resolve_advert`` the canonical spec -------
    advert_policy: Union[str, Sequence[str]] = "periodic"
    # ^ periodic (the paper's fixed cadence — exact legacy behaviour) |
    #   delta (same cadence, measured delta-vs-full bytes on the wire) |
    #   self_adjusting (drift-triggered under a token-bucket budget)
    advert_bandwidth: Union[float, Sequence[float]] = 0.0
    # ^ token-bucket refill, bytes per insertion (self_adjusting only)
    advert_burst: Union[float, Sequence[float]] = 0.0
    # ^ bucket capacity in bytes; 0 -> one full advertisement (m/8)
    advert_threshold: Union[float, Sequence[float]] = 0.05
    # ^ Eq. (7) predicted-FN drift that triggers an advertisement
    advert_check: Union[int, Sequence[int]] = 0
    # ^ insertions between drift checks; 0 -> the cache's est_interval
    q_horizon: int = 100              # Eq. (9) epoch T
    q_delta: float = 0.25             # Eq. (9) smoothing
    policy: str = "fna"               # fna | fna_cal | fno | pi | hocs
    # "hocs": Algorithm 1 (fully-homogeneous optimal) — requires identical
    # costs; uses pooled pi/nu estimates and accesses the r1* cheapest
    # positive + r0* cheapest negative caches.
    alg: str = "ds_pgm"               # ds_pgm | exhaustive (subroutine)
    engine: str = "fast"              # fast | reference (bit-exact twins
    # for every policy; fna_cal uses the speculative segmented replay of
    # repro_torch.cachesim.fna_cal_fast — see module docstring)
    seed: int = 0
    # --- fna_cal (beyond-paper): empirical exclusion-probability feedback ---
    # Eq. (7) counts BITS, inflating FN by ~k when staleness concentrates in
    # few items; fna_cal corrects nu/pi with EWMA outcomes of its own probes
    # (plus epsilon-exploration so the estimate can't freeze).
    cal_gamma: float = 0.05
    cal_min_obs: int = 30
    cal_epsilon: float = 0.005

    def __post_init__(self):
        if len(self.costs) != self.n_caches:
            # synthesise a cost vector ONLY when ``costs`` was left at the
            # class default and the cache count moved away from it; an
            # EXPLICIT mismatch is a config typo and must fail loudly
            # (silently rewriting it ran scenarios with wrong costs)
            default = type(self).__dataclass_fields__["costs"].default
            if tuple(self.costs) != default:
                raise ValueError(
                    f"costs {tuple(self.costs)!r} has length "
                    f"{len(self.costs)}, expected n_caches={self.n_caches}; "
                    f"pass one cost per cache (a (1, 2, 3, ...) vector is "
                    f"only synthesised while costs is left at the class "
                    f"default {default})")
            self.costs = tuple(1.0 + (i % 3) for i in range(self.n_caches))
        # validate per-cache sequence lengths AND values eagerly — a
        # wrong-length sequence or a degenerate interval must fail at
        # construction, not deep inside a sweep
        for f in ("cache_sizes", "bpes", "update_intervals",
                  "est_intervals", "advert_policies", "advert_bandwidths",
                  "advert_bursts", "advert_thresholds", "advert_checks"):
            getattr(self, f)
        if self.q_horizon < 1:
            raise ValueError(
                f"q_horizon must be a positive epoch length, "
                f"got {self.q_horizon!r}")

    def _per_cache(self, value, cast, name: str, minimum=None) -> tuple:
        if isinstance(value, (list, tuple, np.ndarray)):
            vals = tuple(cast(v) for v in value)
            if len(vals) != self.n_caches:
                raise ValueError(
                    f"per-cache sequence {name}={value!r} has length "
                    f"{len(vals)}, expected n_caches={self.n_caches}")
        else:
            vals = (cast(value),) * self.n_caches
        if minimum is not None and any(v < minimum for v in vals):
            raise ValueError(
                f"{name}={value!r} must be >= {minimum} per cache")
        return vals

    @property
    def cache_sizes(self) -> tuple:
        return self._per_cache(self.cache_size, int, "cache_size", 1)

    @property
    def bpes(self) -> tuple:
        vals = self._per_cache(self.bpe, float, "bpe")
        if any(v <= 0 for v in vals):
            raise ValueError(f"bpe={self.bpe!r} must be > 0 per cache")
        return vals

    @property
    def update_intervals(self) -> tuple:
        return self._per_cache(self.update_interval, int,
                               "update_interval", 1)

    @property
    def est_intervals(self) -> tuple:
        return self._per_cache(self.est_interval, int, "est_interval", 1)

    # --- advertisement-event knobs (repro_torch.cachesim.advert) ----------------

    @property
    def advert_policies(self) -> tuple:
        from repro_torch.cachesim.advert import ADVERT_POLICIES
        vals = self._per_cache(self.advert_policy, str, "advert_policy")
        bad = [v for v in vals if v not in ADVERT_POLICIES]
        if bad:
            raise ValueError(
                f"unknown advert_policy {bad[0]!r}; "
                f"known: {ADVERT_POLICIES}")
        return vals

    @property
    def advert_bandwidths(self) -> tuple:
        return self._per_cache(self.advert_bandwidth, float,
                               "advert_bandwidth", 0.0)

    @property
    def advert_bursts(self) -> tuple:
        return self._per_cache(self.advert_burst, float, "advert_burst",
                               0.0)

    @property
    def advert_thresholds(self) -> tuple:
        return self._per_cache(self.advert_threshold, float,
                               "advert_threshold", 0.0)

    @property
    def advert_checks(self) -> tuple:
        return self._per_cache(self.advert_check, int, "advert_check", 0)


@dataclass
class SimResult:
    policy: str
    n_requests: int = 0
    total_cost: float = 0.0
    hits: int = 0
    pos_accesses: int = 0
    neg_accesses: int = 0
    # designated-cache indicator quality (Fig. 1 measurement)
    fn_events: int = 0
    fn_opportunities: int = 0
    fp_events: int = 0
    fp_opportunities: int = 0
    resident: int = 0

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

    def to_dict(self) -> Dict:
        return {
            "policy": self.policy, "n": self.n_requests,
            "mean_cost": round(self.mean_cost, 4),
            "hit_ratio": round(self.hit_ratio, 4),
            "fn_ratio": round(self.fn_ratio, 5),
            "fp_ratio": round(self.fp_ratio, 5),
            "pos_accesses": self.pos_accesses, "neg_accesses": self.neg_accesses,
        }


class _CacheNode:
    def __init__(self, size: int, bpe: float, seed: int,
                 update_interval: int, est_interval: int,
                 advert: tuple = ("periodic", 0.0, 0.0, 0.0, 0)):
        self.lru = LRUCache(size)
        m = int(bpe * size)
        k = optimal_k(bpe)
        self.ind = StaleIndicatorPair(m, k, seed=seed)
        self.update_interval = update_interval
        self.est_interval = est_interval
        # resolved advert spec (repro_torch.cachesim.advert.resolve_advert):
        # (policy, bandwidth bytes/insertion, burst bytes, threshold,
        # check interval)
        (self.adv_policy, self.adv_bandwidth, self.adv_burst,
         self.adv_threshold, self.check_interval) = advert
        self.adv_tokens = float(self.adv_burst)   # bucket starts full
        self.advert_events: List = []             # [(insertion ord, bytes)]
        self.version = 0  # bumped whenever fp/fn estimates change
        self._since_adv = 0
        self._since_est = 0
        self._since_chk = 0
        self._n_ins = 0
        # scalar-lookup memo, bounded: an unbounded per-key memo leaks
        # hundreds of MB on recency-heavy million-request runs (~250k
        # fresh ids per cache).  hash_indices is deterministic, so
        # dropping entries never changes results — the memo is cleared
        # whenever it outgrows a small multiple of the cache size (the
        # working set a scalar caller can actually re-hit).
        self._idx_memo: Dict[int, np.ndarray] = {}
        self._idx_memo_cap = max(2 * int(size), 1024)
        self.ind.advertise()

    def _idx(self, key: int) -> np.ndarray:
        r = self._idx_memo.get(key)
        if r is None:
            r = hash_indices(np.asarray([key], dtype=np.uint64),
                             self.ind.cbf.k, self.ind.cbf.m, self.ind.cbf.seed)[0]
            if len(self._idx_memo) >= self._idx_memo_cap:
                self._idx_memo.clear()
            self._idx_memo[key] = r
        return r

    def stale_query(self, key: int) -> bool:
        return bool(np.all(self.ind.stale[self._idx(key)]))

    def insert(self, key: int, idx: Optional[np.ndarray] = None) -> bool:
        """Controller placement: LRU put + CBF bookkeeping + periodic
        advertisement / estimation driven by insertions.  Returns True when
        the FP/FN estimates changed (``version`` bumped).  ``idx`` lets the
        caller supply the key's precomputed ``hash_indices`` row (the
        reference loop already holds one per request), bypassing the memo.
        """
        inserted, evicted = self.lru.put(key)
        if not inserted:
            return False
        c = self.ind.cbf
        if idx is None:
            idx = self._idx(key)
        c.counters[idx] = np.minimum(c.counters[idx].astype(np.int32) + 1, 255)
        if evicted is not None:
            eidx = self._idx(evicted)
            c.counters[eidx] = np.maximum(c.counters[eidx].astype(np.int32) - 1, 0)
        self._since_adv += 1
        self._since_est += 1
        self._n_ins += 1
        bumped = False
        if self._since_est >= self.est_interval:
            self.ind.estimate_rates()
            self._since_est = 0
            self.version += 1
            bumped = True
        # advertisement decision (repro_torch.cachesim.advert): periodic/delta
        # fire on the fixed insertion cadence; self_adjusting on drift
        # within its token-bucket budget at the check cadence
        if self.adv_policy == "self_adjusting":
            self._since_chk += 1
            if self._since_chk >= self.check_interval:
                self.adv_tokens = _adv.refill(
                    self.adv_tokens, self.adv_burst, self.adv_bandwidth,
                    self.check_interval)
                self._since_chk = 0
                cost = _adv.self_adjusting_decision(
                    self.ind, self.adv_tokens, self.adv_threshold)
                if cost is not None:
                    self.adv_tokens -= cost
                    self._advertise_event(cost)
                    bumped = True
        elif self._since_adv >= self.update_interval:
            self._advertise_event(_adv.advert_cost(self.ind,
                                                   self.adv_policy))
            bumped = True
        return bumped

    def _advertise_event(self, cost: float) -> None:
        """Advertise now: publish the bitmap, reset the staleness
        estimates, and record the (insertion ordinal, bytes) event."""
        self.ind.advertise()
        # a fresh advertisement resets the staleness estimates
        self.ind.estimate_rates()
        self._since_adv = 0
        self._since_est = 0
        self.version += 1
        self.advert_events.append((self._n_ins, float(cost)))


class Simulator:
    """One simulated system under one policy.  ``device`` is where the fast
    engine's decision tables and replay run (``None`` -> ``cuda``, raising
    without a GPU; ``"cpu"`` on request)."""

    def __init__(self, cfg: SimConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        sizes, bpes = cfg.cache_sizes, cfg.bpes
        upd, est = cfg.update_intervals, cfg.est_intervals
        adv = _adv.resolve_advert(cfg)
        self.nodes = [
            _CacheNode(sizes[j], bpes[j], seed=cfg.seed * 1000 + j,
                       update_interval=upd[j], est_interval=est[j],
                       advert=adv[j])
            for j in range(cfg.n_caches)
        ]
        self.q_est = [QEstimator(cfg.q_horizon, cfg.q_delta)
                      for _ in range(cfg.n_caches)]
        self.alg = {"ds_pgm": ds_pgm, "exhaustive": exhaustive}[cfg.alg]

    def _designated(self, key: int) -> int:
        """The single cache the controller places (and measures) ``key`` in."""
        return int(key) % self.cfg.n_caches

    def _designated_batch(self, keys: np.ndarray) -> np.ndarray:
        """Vectorised :meth:`_designated` for the fast engine."""
        return (np.asarray(keys, dtype=np.uint64)
                % np.uint64(self.cfg.n_caches)).astype(np.int64)

    def _refresh_views(self):
        """Recompute per-cache (pi, nu) only when fp/fn/q estimates moved."""
        from repro_torch.core.model import exclusion_probabilities, hit_ratio_from_q
        for j, nd in enumerate(self.nodes):
            ver = (nd.version, self.q_est[j].version)
            if self._view_ver[j] != ver:
                fp, fn, q = nd.ind.fp_est, nd.ind.fn_est, self.q_est[j].value
                h = hit_ratio_from_q(q, fp, fn)
                self._pi[j], self._nu[j] = exclusion_probabilities(h, fp, fn)
                self._view_ver[j] = ver

    def run(self, trace: np.ndarray, result: Optional[SimResult] = None,
            system=None, chunk_size: Optional[int] = None,
            spill=None, report=None) -> SimResult:
        """Simulate ``trace``.  ``system`` optionally supplies a shared
        :class:`~repro_torch.cachesim.systemstate.SystemTrace` computed by an
        earlier fast run over the same (trace, system config) — the sweep
        is then skipped and only the per-policy replay runs.  After a fast
        run, the artifact is published as ``self.last_system``.

        ``chunk_size``/``spill`` stream the fast engine's phase-1 sweep
        through fixed-size trace slices (bit-identical results, bounded
        working set — see ``SystemTrace.compute``); the per-request
        reference loop is already O(1) in the trace and ignores both.
        ``report`` (an optional ``repro_torch.cachesim.engine.RunReport``)
        receives the fast engine's phase times."""
        cfg = self.cfg
        res = result or SimResult(policy=cfg.policy)
        trace = np.asarray(trace, dtype=np.uint64)
        self._pi = [1.0] * cfg.n_caches
        self._nu = [1.0] * cfg.n_caches
        self._view_ver = [None] * cfg.n_caches
        if cfg.engine not in ("fast", "reference"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        if cfg.engine == "fast":
            # run_fast owns the table-budget fallbacks (n beyond the
            # DS_PGM table or exhaustive-enumeration limits drops to the
            # reference loop transparently)
            from repro_torch.cachesim.fastpath import run_fast
            return run_fast(self, trace, res, system=system,
                            chunk_size=chunk_size, spill=spill,
                            report=report)
        return self._run_reference(trace, res)

    def _run_reference(self, trace: np.ndarray, res: SimResult,
                       record: Optional[dict] = None) -> SimResult:
        """The seed per-request scalar loop — the bit-exact oracle.

        ``record``, when given a dict, is filled with the loop's
        per-request observables — ``selm`` (committed post-exploration
        selection bitmask), ``in_dj`` (designated-cache residency),
        ``pats`` (indication-pattern bitmask) and ``dj`` (designated
        cache index) — without altering any computation.  This is how
        ``repro_torch.cachesim.topology`` runs its reference path: the
        same oracle loop per tier, re-accounted under per-tier knobs."""
        cfg = self.cfg
        # view state is (re-)initialised here, not only in run(), so the
        # recording path can drive the oracle loop directly
        self._pi = [1.0] * cfg.n_caches
        self._nu = [1.0] * cfg.n_caches
        self._view_ver = [None] * cfg.n_caches
        costs = list(cfg.costs)
        n = cfg.n_caches
        M = cfg.miss_penalty
        nodes = self.nodes
        # fna_cal empirical estimators (miss prob given indication, per cache).
        # Optimistic init: when FP+FN >= ~1 the indicator is uninformative and
        # h is UNIDENTIFIABLE from (q, FP, FN) — Eq. (1) inversion clamps to
        # h=0, nu=1 and no model-based policy ever probes.  Optimism under
        # uncertainty bootstraps the empirical estimator out of that fixed
        # point (see EXPERIMENTS.md §Perf R-series).
        cal = cfg.policy == "fna_cal"
        nu_emp = [0.90] * n
        pi_emp = [0.5] * n
        nu_obs = [0] * n
        pi_obs = [0] * n
        g = cfg.cal_gamma
        rng_cal = np.random.default_rng(cfg.seed + 12345)
        eps_draws = rng_cal.random(trace.shape[0]) if cal else None
        eps_pick = rng_cal.integers(0, n, trace.shape[0]) if cal else None
        # vectorised stale-query indices for the whole trace, per cache
        idx_all = [hash_indices(trace, nd.ind.cbf.k, nd.ind.cbf.m, nd.ind.cbf.seed)
                   for nd in nodes]
        is_pi = cfg.policy == "pi"
        is_fna = cfg.policy == "fna"
        alg = self.alg
        if record is not None:
            Nr = trace.shape[0]
            record["selm"] = np.zeros(Nr, dtype=np.int64)
            record["in_dj"] = np.zeros(Nr, dtype=bool)
            record["pats"] = np.zeros(Nr, dtype=np.int64)
            record["dj"] = np.zeros(Nr, dtype=np.int64)
        for i in range(trace.shape[0]):
            x = int(trace[i])
            indications = [bool(nodes[j].ind.stale[idx_all[j][i]].all())
                           for j in range(n)]
            for qe, ind in zip(self.q_est, indications):
                qe.observe(ind)
            # --- indicator-quality measurement on the designated cache ---
            dj = self._designated(x)
            in_dj = x in nodes[dj].lru
            if in_dj:
                res.fn_opportunities += 1
                res.fn_events += int(not indications[dj])
                res.resident += 1
            else:
                res.fp_opportunities += 1
                res.fp_events += int(indications[dj])
            # --- selection ---
            if is_pi:
                sel = perfect_information(costs, [x in nd.lru for nd in nodes])
            else:
                self._refresh_views()
                if cfg.policy == "fna_cal":
                    # blend: model-based (Eqs. 7-9) until enough probe
                    # outcomes; switch to the empirical EWMA immediately when
                    # the indicator is uninformative (FP+FN ~ 1)
                    rhos = []
                    for j in range(n):
                        uninformative = (nodes[j].ind.fp_est +
                                         nodes[j].ind.fn_est) >= 0.95
                        if indications[j]:
                            use_emp = pi_obs[j] >= cfg.cal_min_obs or uninformative
                            r = pi_emp[j] if use_emp else self._pi[j]
                        else:
                            use_emp = nu_obs[j] >= cfg.cal_min_obs or uninformative
                            r = nu_emp[j] if use_emp else self._nu[j]
                        rhos.append(r)
                    sel = alg(costs, rhos, M)
                    if eps_draws[i] < cfg.cal_epsilon:  # forced exploration
                        jx = int(eps_pick[i])
                        if jx not in sel:
                            sel = sorted(sel + [jx])
                elif cfg.policy == "hocs":  # Algorithm 1 (homogeneous)
                    pos = [j for j in range(n) if indications[j]]
                    neg = [j for j in range(n) if not indications[j]]
                    pi_h = sum(self._pi) / n
                    nu_h = sum(self._nu) / n
                    from repro_torch.core import hocs_fna as _hocs
                    r0, r1 = _hocs(len(pos), n, pi_h, nu_h, M)
                    sel = sorted(pos[:r1] + neg[:r0])
                elif is_fna:  # Algorithm 2: rho = pi on positive, nu on negative
                    rhos = [self._pi[j] if indications[j] else self._nu[j]
                            for j in range(n)]
                    sel = alg(costs, rhos, M)
                else:       # FNO: positive-indication caches only
                    pos = [j for j in range(n) if indications[j]]
                    if pos:
                        sub = alg([costs[j] for j in pos],
                                  [self._pi[j] for j in pos], M)
                        sel = [pos[t] for t in sub]
                    else:
                        sel = []
                if cal:  # feed probe outcomes back into the estimators
                    for j in sel:
                        absent = x not in nodes[j].lru
                        if indications[j]:
                            pi_emp[j] = (1 - g) * pi_emp[j] + g * absent
                            pi_obs[j] += 1
                        else:
                            nu_emp[j] = (1 - g) * nu_emp[j] + g * absent
                            nu_obs[j] += 1
            if record is not None:
                record["in_dj"][i] = in_dj
                record["dj"][i] = dj
                record["pats"][i] = sum(1 << j for j in range(n)
                                        if indications[j])
                record["selm"][i] = sum(1 << j for j in sel)
            # --- realised cost ---
            cost = sum(costs[j] for j in sel)
            hit = any(x in nodes[j].lru for j in sel)
            if not hit:
                cost += M
            res.total_cost += cost
            res.hits += int(hit)
            res.pos_accesses += sum(1 for j in sel if indications[j])
            res.neg_accesses += sum(1 for j in sel if not indications[j])
            res.n_requests += 1
            # --- system update: fetch-and-place into the designated cache ---
            # reuse the request's precomputed hash row (bit-exact by
            # construction) so the scalar memo only ever sees evictions
            nodes[dj].insert(x, idx=idx_all[dj][i])
        # advert-event totals ride as plain attributes (NOT dataclass
        # fields — the golden harness serialises every SimResult field and
        # pre-existing golden files must stay byte-identical)
        res.advert_events = (getattr(res, "advert_events", 0) +
                             sum(len(nd.advert_events) for nd in nodes))
        res.advert_bytes = (getattr(res, "advert_bytes", 0.0) +
                            sum(b for nd in nodes
                                for _, b in nd.advert_events))
        return res


def run_policies(trace: np.ndarray, base: SimConfig,
                 policies: Sequence[str] = ("fna", "fno", "pi"),
                 share_system: bool = True,
                 device: DeviceLike = None,
                 report=None) -> Dict[str, SimResult]:
    """Run several policies over the same trace (independent sim instances —
    cache dynamics are identical by construction) on ``device`` (``None``
    -> ``cuda``).

    On the fast engine the policy-independent system sweep is computed
    exactly once and every policy only pays its decision-plan/replay
    phase (the single-cell case of
    :func:`repro_torch.cachesim.engine.run_cells`).  Pass
    ``share_system=False`` to force per-policy full runs (benchmarking).
    ``report`` (an optional ``repro_torch.cachesim.engine.RunReport``)
    receives the system sweep and the phase times."""
    from repro_torch.cachesim.engine import run_cells
    return run_cells(trace, [base], policies, share_system=share_system,
                     device=device, report=report)[0]
