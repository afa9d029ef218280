"""Policy-independent system-state sweep (phase 1 of the fast engine).

The simulator's SYSTEM state — LRU contents, CBF counters, stale bitmaps,
FP/FN estimates (Eqs. 7-8), q-estimates (Eq. 9) — evolves independently of
any policy's access decisions: the controller places every missed request
in its hash-designated cache, so cache dynamics are identical across
policies by construction (paper Sec. V-A, the fair-comparison property).

:class:`SystemTrace` materialises one full sweep of that evolution for a
given (trace, system config) pair:

  * per-request arrays: the n-bit indication pattern of every request
    against the advertisement-frozen bitmaps (invariant I1), designated-
    cache membership, and the designated cache id;
  * the complete client-side view-version history — every (pi, nu) view
    the reference loop's ``_refresh_views`` would compute, PLUS the raw
    (fp, fn) estimates behind it (the calibrated policy's uninformative-
    indicator test reads those directly), with the first request index at
    which each version takes effect (invariant I2);
  * the designated-cache indicator-quality counters (Fig. 1 measurement);
  * a snapshot of the end-of-run system state, so a simulator that skips
    the sweep still finishes in exactly the state a full run would leave.

Because none of this depends on the policy, a policy x trace sweep pays
for ONE system sweep and reuses it for every policy: ``run_policies`` and
``repro_torch.cachesim.sweep`` hand the artifact of the first fast run to
every subsequent simulator, which then only executes the cheap per-policy
table/replay phases (``repro_torch.cachesim.fastpath``,
``repro_torch.cachesim.fna_cal_fast``).

The sweep itself is the reference's NumPy/Python phase 1, unchanged (a
copy of ``repro.cachesim.systemstate``).  A :class:`SystemTrace` carries
the device of the simulator that computed it; the per-request arrays that
the replay reads and the view history are moved there once
(:meth:`SystemTrace.device_arrays`).  :meth:`SystemTrace.from_arrays`
rebuilds one from a ``to_arrays()`` payload — the artifact store's, or
the JAX package's (the layouts are identical), so phases 2-3 can run on
exactly the reference's phase-1 state.

``SWEEPS_COMPUTED`` counts :meth:`SystemTrace.compute` calls — tests use
it to prove a multi-policy run performed exactly one sweep.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hash_indices
from repro_torch.cachesim.advert import (advert_cost, refill, resolve_advert,
                                         self_adjusting_decision)

# incremented on every full system sweep (amortisation observability)
SWEEPS_COMPUTED = 0

#: the fixed field order quality counters serialise under (the store
#: schema, which the reference's ``to_arrays`` shares)
_QUALITY_KEYS = ("fn_events", "fn_opportunities", "fp_events",
                 "fp_opportunities", "resident")


def _dedup_rows(rows: np.ndarray) -> np.ndarray:
    """Unique indices per row, flattened.  The reference CBF update uses
    fancy-index assignment, so duplicate probe indices within one key must
    count once."""
    s = np.sort(rows, axis=1)
    keep = np.ones(s.shape, dtype=bool)
    keep[:, 1:] = s[:, 1:] != s[:, :-1]
    return s[keep]


def _lru_sweep(lru, trace: np.ndarray, pos: np.ndarray):
    """Advance one cache's LRU through its designated subsequence.

    Returns (membership-before-put per request, global positions of the
    requests that inserted, evicted keys, insert index of each eviction).
    Identical ops on the same OrderedDict as ``LRUCache.put`` would do.
    """
    d = lru._d
    cap = lru.capacity
    keys = trace[pos].tolist()
    mem: List[bool] = []
    ins_local: List[int] = []
    evict_keys: List[int] = []
    evict_iidx: List[int] = []
    mem_append = mem.append
    move_to_end = d.move_to_end
    popitem = d.popitem
    ins_append = ins_local.append
    for li, x in enumerate(keys):
        if x in d:
            move_to_end(x)
            mem_append(True)
        else:
            mem_append(False)
            if len(d) >= cap:
                ev, _ = popitem(False)
                evict_keys.append(ev)
                evict_iidx.append(len(ins_local))
            d[x] = None
            ins_append(li)
    ins_gpos = pos[np.asarray(ins_local, dtype=np.int64)] if ins_local \
        else np.empty(0, np.int64)
    return (np.asarray(mem, dtype=bool), ins_gpos, evict_keys,
            np.asarray(evict_iidx, dtype=np.int64))


def _cbf_event_walk(nd, j: int, idx_j: np.ndarray, ins_gpos: np.ndarray,
                    evict_keys, evict_iidx: np.ndarray,
                    ind_all: np.ndarray, est_events: List[Tuple], N: int,
                    *, base: int = 0, cnt=None, finalize: bool = True):
    """Jump from one estimate/advertise/drift-check boundary to the next
    (no per-request work): bulk-apply the window's CBF updates, fire the
    same ``estimate_rates``/``advertise``/token-bucket calls the reference
    ``insert`` would, fill this cache's indication column per
    advertisement segment, record (effective request index, fp, fn) for
    every version bump, and append the cache's advert events ``(absolute
    insertion ordinal, bytes)`` exactly as the reference loop does.

    Under ``periodic``/``delta`` advertisements fire on the fixed
    ``update_interval`` grid; under ``self_adjusting`` the cadence grid is
    the drift-check interval instead (``update_interval`` never fires) and
    an advertisement happens only when the shared
    :func:`~repro_torch.cachesim.advert.self_adjusting_decision` gate opens —
    called at the identical system state and token balance as the
    reference loop, so the engines stay bit-exact twins.

    Chunked phase 1 calls this once per (chunk, cache) with LOCAL arrays:
    ``base`` is the chunk's global request offset (recorded-event indices
    are globalised), ``cnt`` carries the working int32 counter array from
    the previous chunk, and ``finalize=False`` defers the one uint8 clip
    to the trace end — exactly where the one-shot walk performs it.  The
    cadence/token carries (``nd._since_*``, ``nd.adv_tokens``,
    ``nd._n_ins``) are reconstructed at every call's end either way, so a
    chunk boundary is indistinguishable from a walk entry.  Returns the
    working counter array for the next chunk's carry."""
    cbf = nd.ind.cbf
    if cnt is None:
        cnt = cbf.counters.astype(np.int32)
    cbf.counters = cnt              # estimate/advertise read through cbf
    ins_rows = idx_j[ins_gpos]
    ev_rows = hash_indices(np.asarray(evict_keys, dtype=np.uint64),
                           cbf.k, cbf.m, cbf.seed) if evict_keys else None
    n_ins = int(ins_gpos.shape[0])
    seg_start = 0                   # indication segment start (request idx)
    cur = 0                         # inserts flushed so far
    ev_ptr = 0
    self_adj = nd.adv_policy == "self_adjusting"
    next_est = nd.est_interval - nd._since_est
    # the inactive cadence gets an out-of-range sentinel so it never fires
    next_adv = (nd.update_interval - nd._since_adv) if not self_adj \
        else n_ins + 1
    next_chk = (nd.check_interval - nd._since_chk) if self_adj \
        else n_ins + 1
    last_adv = -nd._since_adv       # self_adjusting staleness origin
    n_ins0 = nd._n_ins              # absolute ordinal of insert #0 here

    def flush(upto: int) -> None:
        nonlocal cur, ev_ptr
        if upto <= cur:
            return
        np.add.at(cnt, _dedup_rows(ins_rows[cur:upto]), 1)
        hi = int(np.searchsorted(evict_iidx, upto, side="left"))
        if hi > ev_ptr:
            np.subtract.at(cnt, _dedup_rows(ev_rows[ev_ptr:hi]), 1)
            ev_ptr = hi
        cur = upto

    while True:
        nxt = min(next_est, next_adv, next_chk)
        if nxt > n_ins:
            break
        flush(nxt)
        g = int(ins_gpos[nxt - 1])  # request whose insert fired the event
        bumps = 0
        if next_est == nxt:         # reference order: estimate first
            nd.ind.estimate_rates()
            bumps += 1
            next_est = nxt + nd.est_interval
        cost = None
        if next_adv == nxt:         # periodic/delta fixed cadence
            cost = advert_cost(nd.ind, nd.adv_policy)
        elif next_chk == nxt:       # self_adjusting drift check
            nd.adv_tokens = refill(nd.adv_tokens, nd.adv_burst,
                                   nd.adv_bandwidth, nd.check_interval)
            next_chk = nxt + nd.check_interval
            cost = self_adjusting_decision(nd.ind, nd.adv_tokens,
                                           nd.adv_threshold)
        if cost is not None:
            # indications in [seg_start, g] used the OLD stale bitmap
            np.all(nd.ind.stale[idx_j[seg_start:g + 1]], axis=1,
                   out=ind_all[seg_start:g + 1, j])
            nd.ind.advertise()
            # a fresh advertisement resets the staleness estimates
            nd.ind.estimate_rates()
            bumps += 1
            seg_start = g + 1
            next_est = nxt + nd.est_interval
            if self_adj:
                nd.adv_tokens -= cost
                last_adv = nxt
            else:
                next_adv = nxt + nd.update_interval
            nd.advert_events.append((n_ins0 + nxt, float(cost)))
        if bumps:                   # a silent drift check bumps nothing
            nd.version += bumps
            est_events.append((base + g + 1, 0, j,
                               nd.ind.fp_est, nd.ind.fn_est))
    flush(n_ins)
    np.all(nd.ind.stale[idx_j[seg_start:N]], axis=1,
           out=ind_all[seg_start:N, j])
    if finalize:
        cbf.counters = np.clip(cnt, 0, 255).astype(np.uint8)
    nd._since_est = nd.est_interval - (next_est - n_ins)
    if self_adj:
        nd._since_adv = n_ins - last_adv
        nd._since_chk = nd.check_interval - (next_chk - n_ins)
    else:
        nd._since_adv = nd.update_interval - (next_adv - n_ins)
    nd._n_ins = n_ins0 + n_ins
    return cnt


def _q_epoch_walk(q_est, ind_all: np.ndarray, N: int,
                  base: int = 0) -> List[Tuple]:
    """Advance the q-estimators through the whole trace, one batched
    ``_close_epoch`` per epoch boundary (bit-exact: positives are integer
    counts).  Returns (effective request index, q) events per cache.

    ``QEstimator.observe_batch`` is exactly split-invariant, so the
    chunked phase 1 calls this once per chunk with the chunk's local
    ``ind_all`` slice and its global offset as ``base`` (event indices
    are globalised) — the fold is bit-identical to one whole-trace
    call."""
    events: List[Tuple] = []
    horizon = q_est[0].horizon
    first = horizon - q_est[0]._count   # requests closing the first epoch
    bounds = range(first, N + 1, horizon)
    for j, qe in enumerate(q_est):
        col = ind_all[:, j]
        prev = 0
        for b in bounds:            # each slice closes exactly one epoch
            qe.observe_batch(col[prev:b])
            events.append((base + b - 1, 1, j, qe.q))
            prev = b
        qe.observe_batch(col[prev:N])   # partial tail
    return events


def _assemble_versions(n: int, fp0, fn0, q0, events, N: int):
    """Replay the recorded estimate/q events chronologically into the
    client view-version history — the same floats ``_refresh_views`` would
    produce at each decision, plus the raw (fp, fn) behind them (the
    calibrated blend reads those live).  Returns (pi_v, nu_v, fp_v, fn_v)
    as [V, n] float64 arrays and ``points`` where points[i] = (first
    request index using version i, version id)."""
    from repro_torch.core.model import exclusion_probabilities, hit_ratio_from_q
    fp, fn, q = list(fp0), list(fn0), list(q0)
    pi = [0.0] * n
    nu = [0.0] * n

    def view(js) -> None:
        for j in js:
            h = hit_ratio_from_q(q[j], fp[j], fn[j])
            pi[j], nu[j] = exclusion_probabilities(h, fp[j], fn[j])

    view(range(n))
    versions = [(tuple(pi), tuple(nu), tuple(fp), tuple(fn))]
    points = [(0, 0)]
    events = sorted(events)
    i = 0
    while i < len(events):
        eff = events[i][0]
        touched = set()
        while i < len(events) and events[i][0] == eff:
            _, kind, j = events[i][:3]
            if kind == 0:
                fp[j], fn[j] = events[i][3], events[i][4]
            else:
                q[j] = events[i][3]
            touched.add(j)
            i += 1
        if eff >= N:        # bump on the last request: no decision left
            continue
        view(touched)
        v = (tuple(pi), tuple(nu), tuple(fp), tuple(fn))
        if versions[-1] != v:
            versions.append(v)
            points.append((eff, len(versions) - 1))
    pi_v = np.asarray([v[0] for v in versions], np.float64)
    nu_v = np.asarray([v[1] for v in versions], np.float64)
    fp_v = np.asarray([v[2] for v in versions], np.float64)
    fn_v = np.asarray([v[3] for v in versions], np.float64)
    return pi_v, nu_v, fp_v, fn_v, points


#: distinct spill-directory suffixes within one process (path uniqueness)
_SPILL_SEQ = itertools.count()


def _alloc_outputs(N: int, n: int, spill):
    """Allocate the five per-request output arrays of one sweep:
    ``(ind_all [N, n] bool, in_dj [N] bool, dj_all [N] int64,
    pats [N] int64, ver_per_req [N] int64)``.

    ``spill=None`` -> plain RAM.  Otherwise preallocated ``.npy``
    memmaps under the given directory (or under a fresh
    ``ArtifactStore.spill_dir()`` when passed a store), filled
    chunk-by-chunk by the caller — memmaps ARE ndarrays, so every
    downstream consumer (replay, ``to_arrays``, the store) works
    unchanged.  The caller owns the directory's lifetime; ``N == 0``
    falls back to RAM (zero-byte files cannot be mmapped)."""
    if spill is None or N == 0:
        return (np.empty((N, n), dtype=bool), np.empty(N, dtype=bool),
                np.empty(N, dtype=np.int64), np.empty(N, dtype=np.int64),
                np.empty(N, dtype=np.int64))
    from numpy.lib.format import open_memmap
    if hasattr(spill, "spill_dir"):     # an ArtifactStore
        d = spill.spill_dir()
    else:
        d = Path(spill) / f"sweep-{os.getpid()}-{next(_SPILL_SEQ)}"
    d.mkdir(parents=True, exist_ok=True)

    def mm(name, dtype, shape):
        return open_memmap(str(d / f"{name}.npy"), mode="w+",
                           dtype=dtype, shape=shape)

    return (mm("ind_all", bool, (N, n)), mm("in_dj", bool, (N,)),
            mm("dj_all", np.int64, (N,)), mm("pats", np.int64, (N,)),
            mm("ver_per_req", np.int64, (N,)))


def _is_fresh(sim) -> bool:
    return (all(nd.version == 0 and len(nd.lru) == 0 and
                nd._since_adv == 0 and nd._since_est == 0 and
                nd._since_chk == 0 and nd._n_ins == 0 and
                not nd.advert_events and nd.adv_tokens == nd.adv_burst
                for nd in sim.nodes) and
            all(qe.version == 0 and qe._count == 0 and not qe._bootstrapped
                for qe in sim.q_est))


@dataclass
class SystemTrace:
    """One materialised system sweep, reusable across policies.

    See the module docstring; produced by :meth:`compute` (which advances
    the donor simulator's nodes in place) and consumed either by the same
    simulator or — via :meth:`install` — by any other FRESH simulator with
    an identical system configuration and trace.  ``device`` is where the
    decision tables (``plan_cache``) and the replay live."""
    key: tuple
    n: int
    trace_len: int
    ind_all: np.ndarray         # [N, n] bool — indications vs stale bitmaps
    in_dj: np.ndarray           # [N] bool — designated-cache membership
    dj_all: np.ndarray          # [N] int64 — designated cache per request
    pats: np.ndarray            # [N] int64 — n-bit indication pattern
    ver_per_req: np.ndarray     # [N] int64 — view-version id per request
    pi_v: np.ndarray            # [V, n] float64 — per-version model views
    nu_v: np.ndarray
    fp_v: np.ndarray            # [V, n] float64 — raw estimates behind them
    fn_v: np.ndarray
    quality: Dict[str, int]     # designated-cache indicator-quality counters
    final_state: dict           # end-of-run system state snapshot
    from_fresh: bool
    _trace: np.ndarray          # held only for identity checks on install
    device: torch.device = torch.device("cpu")
    # decision tables memoised per decision-side configuration (costs,
    # miss penalty, CS_FNO flag) as [V * 2^n] int64 tensors on ``device``
    # — written by the table plans of ``repro_torch.cachesim.engine`` and
    # by its stacked cross-cell prefetch, read back at replay time
    plan_cache: Dict[tuple, torch.Tensor] = field(default_factory=dict)
    # forwarded-stream positions (see forward_positions); None = derive
    _fwd_pos: Optional[np.ndarray] = None
    # phase 3's inputs on ``device`` (see device_arrays); empty = not moved
    _dev: Dict[str, torch.Tensor] = field(default_factory=dict)

    # -- construction ------------------------------------------------------

    @staticmethod
    def system_key(cfg) -> tuple:
        """The SimConfig fields the system evolution depends on (policy,
        costs, miss penalty and calibration knobs are decision-side only).
        Per-cache fields enter as their normalised tuples, so a scalar and
        its broadcast sequence hash identically; the advert spec enters in
        its :func:`~repro_torch.cachesim.advert.resolve_advert` canonical form,
        so budget knobs a policy does not read cannot split sharing."""
        return (cfg.n_caches, cfg.cache_sizes, cfg.bpes,
                cfg.update_intervals, cfg.est_intervals,
                cfg.q_horizon, cfg.q_delta, cfg.seed,
                resolve_advert(cfg))

    @classmethod
    def compute(cls, sim, trace: np.ndarray, chunk_size: Optional[int] = None,
                spill=None) -> "SystemTrace":
        """Run the full sweep on ``sim``'s nodes (advancing them in place
        to the end-of-run state) and record everything any policy replay
        needs.

        ``chunk_size`` folds the trace through the sweep in slices of
        that many requests: the LRU dict, the int32 CBF working counters,
        the advert cadence/token carries and the q-estimators thread
        through chunk boundaries unchanged, so the result is BIT-IDENTICAL
        to the one-shot sweep (``chunk_size=None``, a single fold
        iteration) while the transient working set — raw hash-index rows,
        designated positions, eviction lists — stays O(chunk) instead of
        O(trace).

        ``spill`` (a directory path or an ``ArtifactStore``, whose
        ``spill_dir()`` then scopes the files) additionally backs the
        per-request OUTPUT arrays by preallocated ``.npy`` memmaps filled
        chunk-by-chunk, bounding peak RSS at O(chunk + cache state); the
        memmaps are ordinary ndarrays to every consumer.  The caller owns
        the spill directory's lifetime.

        The result lives on ``sim.device``."""
        global SWEEPS_COMPUTED
        SWEEPS_COMPUTED += 1
        n = sim.cfg.n_caches
        nodes = sim.nodes
        N = int(trace.shape[0])
        fresh = _is_fresh(sim)
        if chunk_size is not None:
            # same contract as iter_trace_chunks: reject early, by name
            from repro_torch.cachesim.tracefiles import validate_chunk_size
            validate_chunk_size(chunk_size)
        step = N if chunk_size is None else min(int(chunk_size), N)

        # view inputs at entry — events below record every later change
        fp0 = [nd.ind.fp_est for nd in nodes]
        fn0 = [nd.ind.fn_est for nd in nodes]
        q0 = [qe.q for qe in sim.q_est]

        ind_all, in_dj, dj_all, pats, ver_per_req = _alloc_outputs(
            N, n, spill)
        events: List[Tuple] = []
        cnt_carry: List = [None] * n        # int32 CBF working counters
        pow2 = 1 << np.arange(n, dtype=np.int64)
        # indicator-quality measurement on the designated cache (Fig. 1)
        quality = {"fn_events": 0, "fn_opportunities": 0, "fp_events": 0,
                   "fp_opportunities": 0, "resident": 0}
        start = 0
        while start < N:
            stop = min(start + step, N)
            nc = stop - start
            tchunk = trace[start:stop]
            last = stop == N
            dj_all[start:stop] = djc = sim._designated_batch(tchunk)
            ind_c = ind_all[start:stop]
            in_dj_c = in_dj[start:stop]
            for j, nd in enumerate(nodes):
                pos = np.flatnonzero(djc == j)
                idx_j = hash_indices(tchunk, nd.ind.cbf.k, nd.ind.cbf.m,
                                     nd.ind.cbf.seed)
                mem, ins_gpos, evict_keys, evict_iidx = _lru_sweep(
                    nd.lru, tchunk, pos)
                in_dj_c[pos] = mem
                cnt_carry[j] = _cbf_event_walk(
                    nd, j, idx_j, ins_gpos, evict_keys, evict_iidx,
                    ind_c, events, nc,
                    base=start, cnt=cnt_carry[j], finalize=last)
                id_ = ind_c[pos, j]
                held = int(np.count_nonzero(mem))
                quality["fn_opportunities"] += held
                quality["resident"] += held
                quality["fn_events"] += int(np.count_nonzero(mem & ~id_))
                quality["fp_opportunities"] += int(pos.shape[0]) - held
                quality["fp_events"] += int(np.count_nonzero(~mem & id_))
            events.extend(_q_epoch_walk(sim.q_est, ind_c, nc, base=start))
            pats[start:stop] = ind_c @ pow2
            start = stop

        pi_v, nu_v, fp_v, fn_v, points = _assemble_versions(
            n, fp0, fn0, q0, events, N)
        for i, (s0, vid) in enumerate(points):
            s1 = points[i + 1][0] if i + 1 < len(points) else N
            ver_per_req[s0:s1] = vid

        return cls(
            key=cls.system_key(sim.cfg), n=n, trace_len=N,
            ind_all=ind_all, in_dj=in_dj, dj_all=dj_all, pats=pats,
            ver_per_req=ver_per_req,
            pi_v=pi_v, nu_v=nu_v, fp_v=fp_v, fn_v=fn_v,
            quality=quality,
            final_state=cls._snapshot(sim),
            from_fresh=fresh, _trace=trace, device=sim.device)

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """What phases 2-3 read, on ``self.device`` — moved there once and
        kept: ``ver`` / ``pats`` / ``dj`` [N] int64, ``in_dj`` [N] bool,
        ``pi`` / ``nu`` [V, n] float64."""
        if not self._dev:
            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=self.device)
            self._dev.update(
                ver=put(self.ver_per_req, torch.int64),
                pats=put(self.pats, torch.int64),
                dj=put(self.dj_all, torch.int64),
                in_dj=put(self.in_dj, torch.bool),
                pi=put(self.pi_v, torch.float64),
                nu=put(self.nu_v, torch.float64))
        return self._dev

    @staticmethod
    def _snapshot(sim) -> dict:
        return {
            "nodes": [{
                "lru_keys": list(nd.lru._d.keys()),
                "counters": nd.ind.cbf.counters.copy(),
                "stale": nd.ind.stale.copy(),
                "fp_est": nd.ind.fp_est, "fn_est": nd.ind.fn_est,
                "version": nd.version,
                "since_adv": nd._since_adv, "since_est": nd._since_est,
                "since_chk": nd._since_chk, "n_ins": nd._n_ins,
                "adv_tokens": nd.adv_tokens,
                "adv_ins": [int(e[0]) for e in nd.advert_events],
                "adv_bytes": [float(e[1]) for e in nd.advert_events],
            } for nd in sim.nodes],
            "q": [{
                "q": qe.q, "version": qe.version, "count": qe._count,
                "positives": qe._positives, "boot": qe._bootstrapped,
            } for qe in sim.q_est],
        }

    # -- topology composition ----------------------------------------------

    def forward_positions(self) -> np.ndarray:
        """Positions (indices into THIS sweep's arrival stream) of the
        requests NOT resident in their designated cache — the
        residency-miss subsequence a parent tier receives when this
        sweep's system is one hop of a hierarchy
        (``repro_torch.cachesim.topology``).  Hash-designated placement
        makes it policy-independent, so the forwarded stream — and with
        it every deeper tier's sweep — is shareable across policies and
        topology cells exactly like the sweep itself.  Derived lazily from
        ``in_dj`` and memoised; stored in the schema-v3 ``.npz`` payload so
        hydrated sweeps skip the scan."""
        if self._fwd_pos is None:
            self._fwd_pos = np.flatnonzero(~self.in_dj).astype(np.int64)
        return self._fwd_pos

    # -- serialisation (the content-addressed artifact store) ---------------

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten the sweep into named ndarrays — the ``.npz`` payload of
        ``repro_torch.cachesim.store``, key for key the JAX package's
        ``SystemTrace.to_arrays``.  Everything a replay consumes
        round-trips bit-exactly: per-request arrays as-is, the
        view-version history as float64, the final-state snapshot as
        concatenated per-node arrays plus length vectors.  The trace
        itself is NOT stored — the store keys entries on its content hash,
        so :meth:`from_arrays` re-attaches the caller's array.
        ``plan_cache`` tables are stored as separate per-key artifacts."""
        fs = self.final_state
        nodes, qs = fs["nodes"], fs["q"]

        def _cat(parts, dtype):
            parts = [np.asarray(p, dtype) for p in parts]
            return (np.concatenate(parts) if parts
                    else np.empty(0, dtype)), \
                np.asarray([p.shape[0] for p in parts], np.int64)

        lru_cat, lru_len = _cat([nd["lru_keys"] for nd in nodes], np.uint64)
        cnt_cat, cnt_len = _cat([nd["counters"] for nd in nodes], np.uint8)
        stale_cat, stale_len = _cat([nd["stale"] for nd in nodes], bool)
        adv_ins_cat, adv_len = _cat([nd["adv_ins"] for nd in nodes],
                                    np.int64)
        adv_bytes_cat, _ = _cat([nd["adv_bytes"] for nd in nodes],
                                np.float64)
        return {
            "n": np.int64(self.n), "trace_len": np.int64(self.trace_len),
            "from_fresh": np.bool_(self.from_fresh),
            "ind_all": self.ind_all, "in_dj": self.in_dj,
            "dj_all": self.dj_all, "pats": self.pats,
            "ver_per_req": self.ver_per_req,
            "fwd_pos": self.forward_positions(),
            "pi_v": self.pi_v, "nu_v": self.nu_v,
            "fp_v": self.fp_v, "fn_v": self.fn_v,
            "quality": np.asarray([self.quality[k] for k in _QUALITY_KEYS],
                                  np.int64),
            "node_lru": lru_cat, "node_lru_len": lru_len,
            "node_counters": cnt_cat, "node_counters_len": cnt_len,
            "node_stale": stale_cat, "node_stale_len": stale_len,
            "node_fp_est": np.asarray([nd["fp_est"] for nd in nodes],
                                      np.float64),
            "node_fn_est": np.asarray([nd["fn_est"] for nd in nodes],
                                      np.float64),
            "node_version": np.asarray([nd["version"] for nd in nodes],
                                       np.int64),
            "node_since_adv": np.asarray([nd["since_adv"] for nd in nodes],
                                         np.int64),
            "node_since_est": np.asarray([nd["since_est"] for nd in nodes],
                                         np.int64),
            "node_since_chk": np.asarray([nd["since_chk"] for nd in nodes],
                                         np.int64),
            "node_n_ins": np.asarray([nd["n_ins"] for nd in nodes],
                                     np.int64),
            "node_adv_tokens": np.asarray([nd["adv_tokens"]
                                           for nd in nodes], np.float64),
            "node_adv_ins": adv_ins_cat, "node_adv_len": adv_len,
            "node_adv_bytes": adv_bytes_cat,
            "q_q": np.asarray([q["q"] for q in qs], np.float64),
            "q_version": np.asarray([q["version"] for q in qs], np.int64),
            "q_count": np.asarray([q["count"] for q in qs], np.int64),
            "q_positives": np.asarray([q["positives"] for q in qs], np.int64),
            "q_boot": np.asarray([q["boot"] for q in qs], bool),
        }

    @classmethod
    def from_arrays(cls, arrays, key: tuple, trace: np.ndarray,
                    device="cpu") -> "SystemTrace":
        """Rebuild a sweep on ``device`` from :meth:`to_arrays` output.
        ``key`` is the ``system_key`` the store looked the entry up under
        (or of the configuration that computed it), ``trace`` the caller's
        (content-hash-verified) request array — the hydrated sweep replays
        bit-identically to the one :meth:`compute` built (``install``
        verifies both against the simulator that replays it)."""
        def _split(cat, lens):
            out, lo = [], 0
            for ln in np.asarray(lens, np.int64).tolist():
                out.append(cat[lo:lo + ln])
                lo += ln
            return out

        lrus = _split(arrays["node_lru"], arrays["node_lru_len"])
        cnts = _split(arrays["node_counters"], arrays["node_counters_len"])
        stales = _split(arrays["node_stale"], arrays["node_stale_len"])
        adv_ins = _split(arrays["node_adv_ins"], arrays["node_adv_len"])
        adv_bytes = _split(arrays["node_adv_bytes"], arrays["node_adv_len"])
        n_nodes = len(lrus)
        final_state = {
            "nodes": [{
                "lru_keys": lrus[j].tolist(),
                "counters": np.ascontiguousarray(cnts[j], np.uint8),
                "stale": np.ascontiguousarray(stales[j], bool),
                "fp_est": float(arrays["node_fp_est"][j]),
                "fn_est": float(arrays["node_fn_est"][j]),
                "version": int(arrays["node_version"][j]),
                "since_adv": int(arrays["node_since_adv"][j]),
                "since_est": int(arrays["node_since_est"][j]),
                "since_chk": int(arrays["node_since_chk"][j]),
                "n_ins": int(arrays["node_n_ins"][j]),
                "adv_tokens": float(arrays["node_adv_tokens"][j]),
                "adv_ins": np.asarray(adv_ins[j], np.int64).tolist(),
                "adv_bytes": np.asarray(adv_bytes[j],
                                        np.float64).tolist(),
            } for j in range(n_nodes)],
            "q": [{
                "q": float(arrays["q_q"][j]),
                "version": int(arrays["q_version"][j]),
                "count": int(arrays["q_count"][j]),
                "positives": int(arrays["q_positives"][j]),
                "boot": bool(arrays["q_boot"][j]),
            } for j in range(int(np.asarray(arrays["q_q"]).shape[0]))],
        }
        quality = {k: int(v) for k, v in
                   zip(_QUALITY_KEYS, np.asarray(arrays["quality"]))}
        return cls(
            key=key, n=int(arrays["n"]), trace_len=int(arrays["trace_len"]),
            ind_all=np.ascontiguousarray(arrays["ind_all"], bool),
            in_dj=np.ascontiguousarray(arrays["in_dj"], bool),
            dj_all=np.ascontiguousarray(arrays["dj_all"], np.int64),
            pats=np.ascontiguousarray(arrays["pats"], np.int64),
            ver_per_req=np.ascontiguousarray(arrays["ver_per_req"], np.int64),
            pi_v=np.ascontiguousarray(arrays["pi_v"], np.float64),
            nu_v=np.ascontiguousarray(arrays["nu_v"], np.float64),
            fp_v=np.ascontiguousarray(arrays["fp_v"], np.float64),
            fn_v=np.ascontiguousarray(arrays["fn_v"], np.float64),
            quality=quality, final_state=final_state,
            from_fresh=bool(arrays["from_fresh"]),
            _trace=np.asarray(trace, dtype=np.uint64),
            device=torch.device(device),
            _fwd_pos=(np.ascontiguousarray(arrays["fwd_pos"], np.int64)
                      if "fwd_pos" in arrays else None))

    # -- reuse -------------------------------------------------------------

    def install(self, sim, trace: np.ndarray) -> None:
        """Skip the sweep for a fresh, same-system simulator: put its nodes
        directly into the recorded end-of-run state."""
        if self.key != self.system_key(sim.cfg):
            raise ValueError(
                "SystemTrace system config mismatch: "
                f"{self.key} != {self.system_key(sim.cfg)}")
        if not self.from_fresh or not _is_fresh(sim):
            raise ValueError("SystemTrace sharing requires fresh simulators")
        if trace.shape[0] != self.trace_len or \
                not np.array_equal(self._trace, trace):
            raise ValueError("SystemTrace was computed for a different trace")
        if self.device != sim.device:
            raise ValueError(f"SystemTrace lives on {self.device}, the "
                             f"simulator on {sim.device}")
        from collections import OrderedDict
        for nd, snap in zip(sim.nodes, self.final_state["nodes"]):
            nd.lru._d = OrderedDict.fromkeys(snap["lru_keys"])
            nd.ind.cbf.counters = snap["counters"].copy()
            nd.ind.stale = snap["stale"].copy()
            nd.ind.fp_est = snap["fp_est"]
            nd.ind.fn_est = snap["fn_est"]
            nd.version = snap["version"]
            nd._since_adv = snap["since_adv"]
            nd._since_est = snap["since_est"]
            nd._since_chk = snap["since_chk"]
            nd._n_ins = snap["n_ins"]
            nd.adv_tokens = snap["adv_tokens"]
            nd.advert_events = list(zip(snap["adv_ins"],
                                        snap["adv_bytes"]))
        for qe, snap in zip(sim.q_est, self.final_state["q"]):
            qe.q = snap["q"]
            qe.version = snap["version"]
            qe._count = snap["count"]
            qe._positives = snap["positives"]
            qe._bootstrapped = snap["boot"]

    def add_quality(self, res) -> None:
        """Accumulate the (policy-independent) Fig. 1 counters."""
        for k, v in self.quality.items():
            setattr(res, k, getattr(res, k) + v)

    def add_advert(self, res) -> None:
        """Attach the (policy-independent) advert-event totals to a
        result, mirroring the reference loop's accumulation — plain
        attributes, NOT SimResult dataclass fields (golden files pin the
        dataclass field set)."""
        nodes = self.final_state["nodes"]
        res.advert_events = (getattr(res, "advert_events", 0) +
                             sum(len(nd["adv_ins"]) for nd in nodes))
        res.advert_bytes = (getattr(res, "advert_bytes", 0.0) +
                            sum(b for nd in nodes
                                for b in nd["adv_bytes"]))

    def advert_streams(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-cache advertisement event streams: one ``(insertion
        ordinals int64, bytes-on-wire float64)`` array pair per cache,
        read from the end-of-run snapshot.  Ordinals are absolute 1-based
        insertion counts into that cache."""
        return [(np.asarray(nd["adv_ins"], np.int64),
                 np.asarray(nd["adv_bytes"], np.float64))
                for nd in self.final_state["nodes"]]
