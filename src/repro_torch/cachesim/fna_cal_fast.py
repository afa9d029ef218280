"""Speculative segmented fast replay for the calibrated policy (fna_cal).

A copy of the JAX package's ``repro.cachesim.fna_cal_fast`` over the
port's ``repro_torch.core.batched``: like the reference, this engine is
host NumPy (its DS_PGM speculation tables and its <= 256-row verification
segments are small and many), except that the exhaustive subroutine's
(version x pattern) speculation tables go through the subset-DP kernel
on the simulator's device; its committed selections replay on the device
(``repro_torch.cachesim.engine.FnaCalSegmented``).

``fna_cal`` corrects the bit-counting FN inflation of Eq. (7) with
empirical probe feedback: per-cache EWMAs of observed exclusion outcomes,
blended with the model views until ``cal_min_obs`` probes accumulate (or
immediately when the indicator is uninformative, FP+FN >= 0.95), plus
epsilon-exploration.  Its EWMAs move on EVERY probe outcome, which breaks
the frozen-view invariant (I2) the table-driven fast path relies on — but
its DECISIONS only change when a drifting rho crosses a DS_PGM decision
boundary, which is far rarer than a probe: measured on the gradle trace
the 2^n decision table changes on ~2% of requests, in a bimodal pattern —
long stable runs punctuated by short flip bursts while a rho hovers at a
boundary.

The engine speculates and commits:

  1. SPECULATE a vectorised replay of a window through a frozen 2^n
     decision table (plus the precomputed epsilon-exploration draws — the
     reference RNG stream is replicated exactly).  The table need not be
     correct — it is a guess whose quality only affects speed — so in the
     post-warmup regime (every branch past min-obs, model views ignored)
     it is patched one row at a time from verification verdicts instead
     of being rebuilt; while model views are still blended in,
     per-view-version tables are rebuilt from the frozen calibration
     state, the whole (version x pattern) batch in one
     ``repro_torch.core.batched`` call (``selection_tables`` backend="numpy" /
     ``exhaustive_tables`` on the device — the same float64 math as the
     verification pass, so a correct speculation always verifies).
  2. RECONSTRUCT the exact calibration-state trajectory the speculated
     probes imply: probe counts are integer cumsums; EWMA paths advance
     per (cache, branch) through :func:`repro_torch.core.estimator.ewma_path` —
     the bit-identical scalar recurrence batched over the segment's probe
     events — and broadcast back per request.  Probe outcomes come free
     from the shared ``SystemTrace``: only the designated cache can hold
     a key, so ``in_dj`` determines every probe's result.
  3. VERIFY with one batched float64 DS_PGM evaluation of the true
     per-request rho matrix (``repro_torch.core.batched.rho_selection_tables``)
     and COMMIT up to the first request whose recomputed EWMA / min-obs /
     exploration state alters the decision.  The mismatched request
     itself is then replayed by one step of the scalar BRIDGE — a
     reference-exact transcription of the decision/feedback loop over the
     precomputed system arrays — which both guarantees forward progress
     independent of float coincidences and yields the fresh table row.
  4. ADAPT: the window doubles on a fully-committed segment and shrinks
     on early mismatch; when commits collapse below the speculation
     break-even (a flip burst), the engine drops into the scalar bridge
     for a stretch instead of thrashing table rebuilds.

Bit-exactness: bridge-committed requests replicate the reference
operations literally; speculatively-committed requests are verified
equal to the float64 batched evaluation of the true rho (DS_PGM prefix
scan, or the 2^n-subset enumeration when ``alg="exhaustive"``, n <= 12) —
the same near-tie parity caveat as ``repro_torch.cachesim.fastpath``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.cachesim.systemstate import SystemTrace
from repro_torch.core.batched import rho_exhaustive_tables, rho_selection_tables
from repro_torch.core.estimator import ewma_path
from repro_torch.core.policies import ds_pgm_mask, exhaustive_mask

_START_WINDOW = 512
_SPEC_MIN_WINDOW = 128       # smallest window worth a speculation round
_MAX_WINDOW = 65_536
_CHUNK = 256                 # trajectory/verification granularity: the
# speculated WINDOW can be huge (table lookups are cheap), but the
# expensive exact-state reconstruction + verification walk it in chunks
# and abort at the first mismatching chunk, so the work wasted past a
# mis-speculation is bounded by one chunk instead of the whole window
_BURST_COMMIT = 8            # commits below this => flip burst => bridge
_BRIDGE_LEN = 32             # scalar requests per bridge stretch
# while any branch still blends model views, cap tables built per segment
_MAX_SEG_VERSIONS = 16


def replay_fna_cal(sim, st: SystemTrace, res):
    """Full fna_cal fast replay: committed selections (moved to
    ``st.device`` once) + the shared fold."""
    from repro_torch.cachesim.fastpath import accumulate_replay
    selm = torch.as_tensor(fna_cal_selections(sim, st), device=st.device)
    return accumulate_replay(res, st, selm,
                             [float(c) for c in sim.cfg.costs],
                             float(sim.cfg.miss_penalty))


def fna_cal_selections(sim, st: SystemTrace) -> np.ndarray:
    """[N] committed (post-exploration) selection bitmasks for fna_cal —
    the speculate/verify/bridge engine described in the module docstring,
    minus the cost fold.  Exposed separately so the topology layer can
    re-account the same decisions under per-tier penalties."""
    cfg = sim.cfg
    n = st.n
    N = st.trace_len
    k = 1 << n
    costs = [float(c) for c in cfg.costs]
    M = float(cfg.miss_penalty)
    g = float(cfg.cal_gamma)
    min_obs = int(cfg.cal_min_obs)
    # the speculate-and-commit loop is subroutine-agnostic: it needs a
    # scalar bitmask call (bridge/table rows) and a batched float64
    # verifier over an arbitrary rho matrix.  ds_pgm pairs the stripped
    # scalar variant with the prefix-scan verifier; exhaustive (n <= 12 —
    # the Simulator dispatch falls back to the reference loop beyond the
    # table budget) pairs it with the batched 2^n-subset enumeration.
    if cfg.alg == "exhaustive":
        mask_fn, verify_fn = exhaustive_mask, rho_exhaustive_tables
    else:
        mask_fn, verify_fn = ds_pgm_mask, rho_selection_tables
    arange_n = np.arange(n)
    pow2 = (np.int64(1) << arange_n).astype(np.int64)
    bits_of = ((np.arange(k)[:, None] >> arange_n) & 1).astype(bool)  # [2^n, n]

    # epsilon-exploration draws: the exact RNG stream of the reference loop
    rng = np.random.default_rng(cfg.seed + 12345)
    eps_draws = rng.random(N)
    eps_pick = rng.integers(0, n, N)
    eps_bits = np.where(eps_draws < cfg.cal_epsilon,
                        np.int64(1) << eps_pick, np.int64(0))

    ver = st.ver_per_req
    # probe outcome per (request, cache): only the designated cache can
    # hold a key, so absence is a pure function of the shared sweep
    absent = np.ones((N, n), dtype=np.float64)
    absent[np.arange(N), st.dj_all] = (~st.in_dj).astype(np.float64)
    uninf_v = (st.fp_v + st.fn_v) >= 0.95           # [V, n]
    # scalar-bridge views of the per-version data (python lists: the
    # bridge reads a handful of scalars per request)
    uninf_l = uninf_v.tolist()
    mpi_l = st.pi_v.tolist()
    mnu_l = st.nu_v.tolist()

    # calibration state (optimistic init — see the reference loop)
    pi_emp = np.full(n, 0.5, np.float64)
    nu_emp = np.full(n, 0.90, np.float64)
    pi_obs = np.zeros(n, np.int64)
    nu_obs = np.zeros(n, np.int64)

    selm = np.empty(N, dtype=np.int64)      # committed (post-eps) masks

    def bridge(s: int, count: int) -> Tuple[int, int]:
        """Reference-exact scalar replay of ``count`` requests from ``s``:
        per-request blend, scalar DS_PGM, exploration, probe feedback —
        the literal reference operations over the precomputed system
        arrays.  Mutates the calibration state in place; returns (end,
        pre-exploration mask of the last request) — the fresh table row."""
        nonlocal pi_emp, nu_emp, pi_obs, nu_obs
        end = min(s + count, N)
        pe: List[float] = pi_emp.tolist()
        ne: List[float] = nu_emp.tolist()
        po: List[int] = pi_obs.tolist()
        no: List[int] = nu_obs.tolist()
        pats_c = st.pats[s:end].tolist()
        ver_c = ver[s:end].tolist()
        abs_c = absent[s:end].tolist()
        eps_c = eps_bits[s:end].tolist()
        rng_n = range(n)
        base = 0
        for i in range(end - s):
            v = ver_c[i]
            pat = pats_c[i]
            uv = uninf_l[v]
            mp = mpi_l[v]
            mn = mnu_l[v]
            rhos = [
                (pe[j] if (po[j] >= min_obs or uv[j]) else mp[j])
                if (pat >> j) & 1
                else (ne[j] if (no[j] >= min_obs or uv[j]) else mn[j])
                for j in rng_n]
            base = mask_fn(costs, rhos, M)
            m = base | eps_c[i]
            selm[s + i] = m
            ai = abs_c[i]
            mm, j = m, 0
            while mm:
                if mm & 1:
                    a = ai[j]
                    if (pat >> j) & 1:
                        pe[j] = (1.0 - g) * pe[j] + g * a
                        po[j] += 1
                    else:
                        ne[j] = (1.0 - g) * ne[j] + g * a
                        no[j] += 1
                mm >>= 1
                j += 1
        pi_emp = np.asarray(pe, np.float64)
        nu_emp = np.asarray(ne, np.float64)
        pi_obs = np.asarray(po, np.int64)
        nu_obs = np.asarray(no, np.int64)
        return end, base

    def build_tables(vids) -> dict:
        """2^n speculation tables from the frozen calibration state, one
        per view version — the whole (version x pattern) batch produced
        by ONE ``repro_torch.core.batched`` call (``selection_tables`` on
        the host / ``exhaustive_tables`` through the subset-DP kernel on
        ``st.device``) instead of 2^n scalar ``mask_fn`` calls per
        version.  The batched float64 rows match ``verify_fn``'s math
        exactly, so speculation quality only improves; exactness is still
        owned by the verification pass and the scalar bridge."""
        from repro_torch.core.batched import exhaustive_tables, selection_tables
        use_pi = pi_obs >= min_obs
        use_nu = nu_obs >= min_obs
        vids = [int(v) for v in vids]
        rp = np.where(use_pi[None, :] | uninf_v[vids],
                      pi_emp[None, :], st.pi_v[vids])          # [m, n]
        rn = np.where(use_nu[None, :] | uninf_v[vids],
                      nu_emp[None, :], st.nu_v[vids])
        if cfg.alg == "exhaustive":      # the subset-DP kernel on the card
            flat = exhaustive_tables(costs, rp, rn, M, device=st.device
                                     ).reshape(-1).cpu().numpy()
        else:
            tab = selection_tables(costs, rp, rn, M, backend="numpy")
            flat = (tab.reshape(-1, n) @ pow2).astype(np.int64)
        return {v: flat[i * k:(i + 1) * k] for i, v in enumerate(vids)}

    s = 0
    window = _START_WINDOW
    table = None                # steady-state (all-emp) speculation table
    while s < N:
        if window < _SPEC_MIN_WINDOW:           # flip burst: scalar stretch
            s, _ = bridge(s, _BRIDGE_LEN)
            window = _SPEC_MIN_WINDOW
            table = None                        # state moved under the table
            continue
        L = min(window, N - s)
        all_emp = bool((pi_obs >= min_obs).all() and
                       (nu_obs >= min_obs).all())
        if not all_emp:
            # model views in play: decisions are version-dependent, so use
            # exact per-version tables and bound how many a segment builds
            cut = int(np.searchsorted(ver, ver[s] + _MAX_SEG_VERSIONS,
                                      side="left"))
            L = max(min(L, cut - s), 1)
        sl = slice(s, s + L)

        # --- 1. speculate -------------------------------------------------
        if all_emp:
            if table is None:
                table = build_tables([int(ver[s])])[int(ver[s])]
            spec = table[st.pats[sl]]
        else:
            vseg = ver[sl]
            tables = build_tables(np.unique(vseg).tolist())
            spec = np.empty(L, np.int64)
            for v, tab in tables.items():
                vm = vseg == v
                spec[vm] = tab[st.pats[sl][vm]]
        sel_spec = spec | eps_bits[sl]

        # --- 2+3. exact state trajectories + verification, chunk-wise -----
        # (the state at a chunk's start is exact because every previous
        # chunk committed in full; aborting at the first mismatching chunk
        # bounds the work wasted past a mis-speculation)
        commit = 0
        clean = True
        while commit < L and clean:
            c1 = min(commit + _CHUNK, L)
            cl = c1 - commit
            rows = slice(s + commit, s + c1)
            ind_seg = st.ind_all[rows]
            sel_b = bits_of[sel_spec[commit:c1]]        # [cl, n]
            pos_ev = sel_b & ind_seg                    # positive probes
            neg_ev = sel_b & ~ind_seg
            # probe counts BEFORE each request r (+1 row: after the chunk)
            cs_p = np.zeros((cl + 1, n), np.int64)
            cs_n = np.zeros((cl + 1, n), np.int64)
            np.cumsum(pos_ev, axis=0, out=cs_p[1:])
            np.cumsum(neg_ev, axis=0, out=cs_n[1:])
            pi_t = np.empty((cl + 1, n), np.float64)
            nu_t = np.empty((cl + 1, n), np.float64)
            a_seg = absent[rows]
            for j in range(n):
                idx = np.flatnonzero(pos_ev[:, j])
                if idx.size:
                    seq = np.empty(idx.size + 1, np.float64)
                    seq[0] = pi_emp[j]
                    seq[1:] = ewma_path(pi_emp[j], a_seg[idx, j], g)
                    pi_t[:, j] = seq[cs_p[:, j]]
                else:
                    pi_t[:, j] = pi_emp[j]
                idx = np.flatnonzero(neg_ev[:, j])
                if idx.size:
                    seq = np.empty(idx.size + 1, np.float64)
                    seq[0] = nu_emp[j]
                    seq[1:] = ewma_path(nu_emp[j], a_seg[idx, j], g)
                    nu_t[:, j] = seq[cs_n[:, j]]
                else:
                    nu_t[:, j] = nu_emp[j]
            if all_emp:
                rho = np.where(ind_seg, pi_t[:cl], nu_t[:cl])
            else:
                vc = vseg[commit:c1]
                uninf_seg = uninf_v[vc]                 # [cl, n]
                up_t = (pi_obs[None] + cs_p[:cl] >= min_obs) | uninf_seg
                un_t = (nu_obs[None] + cs_n[:cl] >= min_obs) | uninf_seg
                rho = np.where(ind_seg,
                               np.where(up_t, pi_t[:cl], st.pi_v[vc]),
                               np.where(un_t, nu_t[:cl], st.nu_v[vc]))
            true_selm = verify_fn(costs, rho, M) @ pow2
            bad = np.flatnonzero(true_selm != spec[commit:c1])
            ok = cl if bad.size == 0 else int(bad[0])
            clean = bad.size == 0
            selm[s + commit:s + commit + ok] = sel_spec[commit:commit + ok]
            pi_emp = pi_t[ok].copy()
            nu_emp = nu_t[ok].copy()
            pi_obs = pi_obs + cs_p[ok]
            nu_obs = nu_obs + cs_n[ok]
            commit += ok

        # --- 4. adapt ------------------------------------------------------
        s += commit
        if clean:
            window = min(window * 2, _MAX_WINDOW)
        else:
            # replay the mismatched request itself scalar-exactly; its
            # fresh decision patches the (speculation-only) table row
            pat = int(st.pats[s])
            s, row = bridge(s, 1)
            if all_emp and table is not None:
                table[pat] = row
            else:
                table = None
            window = 0 if commit < _BURST_COMMIT \
                else min(max(2 * commit, _SPEC_MIN_WINDOW), _MAX_WINDOW)

    return selm
