"""Batched decision-table builders: torch float64 on the device, plus the
NumPy mirrors the reference keeps on the host.

Port of the JAX package's ``repro.core.batched``:

  * the jnp table math — :func:`ds_pgm_batched`, :func:`selection_tables`,
    :func:`selection_tables_cells` (the two-stage grouped evaluation of the
    reference's jitted ``_cells_tables_kernel``) — is eager torch float64
    on a caller-given device;
  * the exhaustive Eq. (10) tables (:func:`rho_exhaustive_tables`,
    :func:`exhaustive_tables`, :func:`exhaustive_tables_cells`) reach the
    hand-written subset-DP kernel through
    ``repro_torch.kernels.subsetdp.ops.subset_argmin`` (its plain torch
    version for CPU tensors), per-row miss penalties included;
  * the NumPy host paths stay NumPy, as in the reference:
    :func:`rho_selection_tables`, :func:`_subset_dp`, and the HOCS mirror
    (:func:`hocs_fna_batched`, :func:`hocs_selection_tables_cells`).

Parity contract (the reference's ``docs/engine.md`` "Exactness model"):
subset-DP values and masks are bit-exact on every device; DS_PGM masks
are exact except where two prefix costs tie to within the ~1e-12 near-tie
dead-band (``log``/``exp`` may differ by an ulp between the CPU and CUDA,
and from the scalar running product).  Prefix sums are explicit left
folds over the n <= 12 columns, so they round identically on every
device (``torch.cumsum`` promises no order on CUDA), and every sort is
``stable=True`` like ``jnp.argsort`` — equal potential-gain keys are
routine (identical initial views, equal costs).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.device import F64, I64, f64, tensor_device

EPS = 1e-12

# The exhaustive dispatch tiers (single source of truth for the fast
# engine): n <= MAX_EXHAUSTIVE_TABLE_CACHES for the (version x pattern)
# table build, n <= 16 for per-row enumeration (the kernel's limit).
MAX_EXHAUSTIVE_TABLE_CACHES = 12


def _left_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Row-wise prefix sums as an explicit left fold over the columns —
    the sequential order of ``np.cumsum``, identical on every device."""
    cols: List[torch.Tensor] = []
    acc = None
    for j in range(x.shape[1]):
        acc = x[:, j] if acc is None else acc + x[:, j]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def _pattern_bits(n: int, device) -> torch.Tensor:
    """[2^n, n] int64: bit j of pattern p."""
    k = 1 << n
    return ((torch.arange(k, dtype=I64, device=device)[:, None]
             >> torch.arange(n, dtype=I64, device=device)[None, :]) & 1)


def _pattern_rhos(pi: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
    """[V * 2^n, n] rho rows: pi_j where pattern bit j is set, else nu_j."""
    v, n = pi.shape
    bits = _pattern_bits(n, pi.device)
    return torch.where(bits[None, :, :] > 0, pi[:, None, :],
                       nu[:, None, :]).reshape(v * (1 << n), n)


def masks_to_bits(mask: torch.Tensor) -> torch.Tensor:
    """[..., n] bool selection masks -> [...] int64 bitmasks (bit j =
    cache j); an integer sum of distinct powers of two, exact."""
    n = mask.shape[-1]
    shifts = torch.arange(n, dtype=I64, device=mask.device)
    return (mask.to(I64) << shifts).sum(dim=-1)


def _pg_sort(costs_b: torch.Tensor, r: torch.Tensor, allowed_rows=None):
    """DS_PGM's penalty-free half: the stable potential-gain order
    ``c_j / -log(rho_j)`` (excluded caches last) and the sorted prefix
    sums of costs and log-rhos (excluded caches cost inf and drop out of
    the product).  Returns (order, csum, lprod), each [B, n]."""
    key = costs_b / -torch.log(r)
    if allowed_rows is not None:
        key = torch.where(allowed_rows, key, torch.inf)
    order = torch.argsort(key, dim=1, stable=True)           # ascending
    c_sorted = torch.gather(costs_b, 1, order)
    r_sorted = torch.gather(r, 1, order)
    if allowed_rows is not None:
        allowed = torch.gather(allowed_rows, 1, order)
        c_sorted = torch.where(allowed, c_sorted, torch.inf)  # never picked
        r_sorted = torch.where(allowed, r_sorted, 1.0)
    return order, _left_cumsum(c_sorted), _left_cumsum(torch.log(r_sorted))


def _pg_finish(order, csum, lprod, m_col: torch.Tensor) -> torch.Tensor:
    """DS_PGM's penalty half: prefix costs phi(P_i), i = 0..n (0 = the
    empty set) under ``m_col`` [B, 1], first argmin, and the chosen prefix
    scattered back to cache order — [B, n] bool."""
    phi = torch.cat([m_col, csum + m_col * torch.exp(lprod)], dim=1)
    n = order.shape[1]
    pick_sorted = (torch.arange(n, device=order.device)[None, :]
                   < torch.argmin(phi, dim=1)[:, None])
    return torch.zeros_like(pick_sorted).scatter_(1, order, pick_sorted)


def ds_pgm_batched(costs: torch.Tensor, rhos: torch.Tensor, miss_penalty,
                   *, fno_mask: torch.Tensor = None) -> torch.Tensor:
    """Batched DS_PGM prefix evaluation (float64 tensors on one device).

    costs: [N] shared, or [B,N] per row; rhos: [B,N]; miss_penalty: scalar,
    or [B] per row; optional fno_mask [B,N] (nonzero = cache may be
    accessed: CS_FNO passes the positive-indication mask).  Every
    operation is row-local, so a row's mask is independent of what else
    shares the batch.  Returns a selection mask [B,N] (bool).
    """
    b, n = rhos.shape
    dev = rhos.device
    costs = torch.as_tensor(costs, dtype=F64, device=dev)
    costs_b = costs.expand(b, n) if costs.dim() == 1 else costs
    m = torch.as_tensor(miss_penalty, dtype=F64, device=dev)
    m_b = m.expand(b) if m.dim() == 0 else m
    stages = _pg_sort(costs_b, rhos.clamp(EPS, 1.0 - EPS),
                      None if fno_mask is None else fno_mask > 0)
    return _pg_finish(*stages, m_b[:, None])


def selection_tables(costs, pi, nu, miss_penalty, *, fno: bool = False,
                     backend: str = "torch", device=None):
    """[V, 2^n, n] DS_PGM decision tables over ALL indication patterns for
    a whole batch of V view versions.

    ``pi``/``nu`` are [V, n] (or [n]) exclusion probabilities; row (v, p)
    holds the selection mask of view version v for the indication pattern
    whose bit j is ``(p >> j) & 1``; ``fno=True`` restricts candidates to
    positive-indication caches (CS_FNO).

    ``backend="torch"`` evaluates :func:`ds_pgm_batched` on ``device`` (the
    tensors' own device when they are tensors) and returns a bool tensor
    there; ``backend="numpy"`` routes through the host mirror
    :func:`rho_selection_tables` and returns an ndarray — the calibrated
    engine's many small per-segment builds use it, as in the reference.
    """
    if backend == "numpy":
        pi = np.atleast_2d(np.asarray(pi, np.float64))
        nu = np.atleast_2d(np.asarray(nu, np.float64))
        v, n = pi.shape
        k = 1 << n
        pat_bits = (np.arange(k)[:, None] >> np.arange(n)[None, :]) & 1
        rhos = np.where(pat_bits[None, :, :] > 0,
                        pi[:, None, :], nu[:, None, :]).reshape(v * k, n)
        allowed = np.tile(pat_bits.astype(bool), (v, 1)) if fno else None
        return rho_selection_tables(
            costs, rhos, miss_penalty, allowed=allowed).reshape(v, k, n)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    dev = tensor_device(pi, device)
    pi = torch.atleast_2d(f64(pi, dev))
    nu = torch.atleast_2d(f64(nu, dev))
    v, n = pi.shape
    k = 1 << n
    fno_mask = _pattern_bits(n, dev).repeat(v, 1) if fno else None
    mask = ds_pgm_batched(f64(costs, dev), _pattern_rhos(pi, nu),
                          float(miss_penalty), fno_mask=fno_mask)
    return mask.reshape(v, k, n)


def selection_tables_cells(costs_cells, pi, nu, penalties, fno_cells,
                           *, device=None) -> torch.Tensor:
    """[C, V, 2^n, n] DS_PGM decision tables for C decision cells against
    ONE shared [V, n] (pi, nu) view history — one stacked torch evaluation
    in the reference's two stages (``_cells_tables_kernel``).

    The potential-gain order ``c_j / -log(rho_j)`` does not depend on the
    miss penalty, so cells are deduplicated into unique (costs, CS_FNO)
    groups: stage 1 sorts and prefix-sums once per group, stage 2 finishes
    each cell with its own penalty (prefix costs, argmin, scatter back to
    cache order).  Both stages replicate :func:`ds_pgm_batched`'s operation
    chain, so cell c's slice equals a per-cell :func:`selection_tables`
    call.  ``costs_cells``: [C, n]; ``penalties``: [C]; ``fno_cells``: [C].
    """
    dev = tensor_device(pi, device)
    pi = torch.atleast_2d(f64(pi, dev))
    nu = torch.atleast_2d(f64(nu, dev))
    v, n = pi.shape
    k = 1 << n
    rows = v * k
    costs_cells = np.atleast_2d(np.asarray(costs_cells, np.float64))
    penalties = np.asarray(penalties, np.float64)
    fno_cells = np.asarray(fno_cells, bool)
    c = costs_cells.shape[0]
    if c == 0:
        return torch.empty((0, v, k, n), dtype=torch.bool, device=dev)
    # one group per unique (costs, fno) pair, each cell pointing at it
    uniq: dict = {}
    group_idx = [uniq.setdefault((cc.tobytes(), bool(f)), len(uniq))
                 for cc, f in zip(costs_cells, fno_cells)]
    r = _pattern_rhos(pi, nu).clamp(EPS, 1.0 - EPS)
    pat_rows = _pattern_bits(n, dev).repeat(v, 1) > 0           # [rows, n]
    stage1 = [_pg_sort(f64(costs_cells[ci], dev).expand(rows, n), r,
                       pat_rows if fno_cells[ci] else None)
              for ci in [group_idx.index(g) for g in range(len(uniq))]]
    out = torch.empty((c, rows, n), dtype=torch.bool, device=dev)
    for ci in range(c):
        m_col = torch.full((rows, 1), float(penalties[ci]), dtype=F64,
                           device=dev)
        out[ci] = _pg_finish(*stage1[group_idx[ci]], m_col)
    return out.reshape(c, v, k, n)


def rho_selection_tables(costs, rhos, miss_penalty, *, allowed=None
                         ) -> np.ndarray:
    """[B, n] float64 DS_PGM masks for an arbitrary per-request rho matrix
    — the NumPy mirror of :func:`ds_pgm_batched` (same stable potential-
    gain argsort, same ``exp(cumsum(log .))`` prefix evaluation), used by
    the calibrated engine's per-segment verification.  ``allowed`` (bool
    [B, n], optional) restricts row b's candidates like ``fno_mask``.
    A copy of the reference's host path."""
    rhos = np.asarray(rhos, np.float64)
    b, n = rhos.shape
    costs = np.asarray(costs, np.float64)
    M = float(miss_penalty)
    logr = np.log(np.clip(rhos, EPS, 1.0 - EPS))
    key = costs[None, :] / -logr
    if allowed is not None:
        allowed = np.asarray(allowed, bool)
        key = np.where(allowed, key, np.inf)        # excluded -> last
        logr = np.where(allowed, logr, 0.0)         # drop from the product
    order = np.argsort(key, axis=1, kind="stable")
    flat = order + (np.arange(b) * n)[:, None]      # row-flattened gather
    if allowed is None:
        csum = np.cumsum(costs[order], axis=1)
    else:
        costs_b = np.where(allowed, np.broadcast_to(costs, (b, n)), np.inf)
        csum = np.cumsum(np.take_along_axis(costs_b, order, 1), axis=1)
    lprod = np.cumsum(logr.reshape(-1)[flat], axis=1)
    phi = csum + M * np.exp(lprod)                  # prefix costs, i = 1..n
    best = np.argmin(phi, axis=1)
    # the empty prefix (cost M) wins ties, exactly like argmin over [M, phi]
    take = np.where(phi[np.arange(b), best] < M, best + 1, 0)
    pick_sorted = np.arange(n)[None, :] < take[:, None]
    mask = np.empty((b, n), dtype=bool)
    mask.reshape(-1)[flat] = pick_sorted
    return mask


def _subset_dp(costs, rhos, miss_penalty):
    """[B, 2^n] Eq. (10) value of EVERY subset (NumPy), bit-exact with the
    scalar enumeration: a DP that extends each mask by its HIGHEST set bit
    reproduces the scalar loop's ascending-index operation order.
    ``miss_penalty`` is a scalar or [B] per row (the seeded product is the
    only place it enters).  A copy of the reference's golden oracle."""
    rhos = np.asarray(rhos, np.float64)
    b, n = rhos.shape
    k = 1 << n
    costs = np.asarray(costs, np.float64)
    cost_m = np.zeros(k, np.float64)
    prod_m = np.empty((b, k), np.float64)
    prod_m[:, 0] = np.asarray(miss_penalty, np.float64)
    for m in range(1, k):
        hb = m.bit_length() - 1
        rest = m ^ (1 << hb)
        cost_m[m] = cost_m[rest] + costs[hb]
        np.multiply(prod_m[:, rest], rhos[:, hb], out=prod_m[:, m])
    return cost_m[None, :] + prod_m


def _bits_to_masks(best, n: int):
    """[B] subset bitmasks -> [B, n] bool (tensor or ndarray alike)."""
    if isinstance(best, torch.Tensor):
        shifts = torch.arange(n, dtype=I64, device=best.device)
        return ((best[:, None] >> shifts[None, :]) & 1).bool()
    return ((best[:, None] >> np.arange(n)[None, :]) & 1).astype(bool)


def rho_exhaustive_tables(costs, rhos, miss_penalty, *, allowed=None,
                          backend: str = "numpy", device=None):
    """[B, n] bool masks: the exact Eq. (10) minimiser over all 2^n subsets
    for an arbitrary per-request rho matrix (n <= 16), LOWEST qualifying
    mask on exact ties (the scalar ascending enumeration's choice, up to
    its ~1e-12 improvement dead-band).  ``allowed`` (int64 [B], optional)
    restricts row b to subsets of ``allowed[b]``; ``miss_penalty`` is a
    scalar or [B] per row.

    ``backend="numpy"`` evaluates :func:`_subset_dp` on the host (the
    calibrated engine's <= 256-row verification segments, as in the
    reference) and returns an ndarray; ``backend="torch"`` runs
    ``subset_argmin`` on ``device`` — the Hopper kernel for CUDA tensors,
    its plain version on the CPU — and returns a bool tensor there.
    """
    if backend == "torch":
        from repro_torch.kernels.subsetdp.ops import subset_argmin
        dev = tensor_device(rhos, device)
        rhos = f64(rhos, dev)
        best = subset_argmin(costs, rhos, f64(miss_penalty, dev),
                             allowed=allowed)
        return _bits_to_masks(best, rhos.shape[1])
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    rhos = np.asarray(rhos, np.float64)
    b, n = rhos.shape
    if n > 16:
        raise ValueError("rho_exhaustive_tables() limited to n <= 16")
    k = 1 << n
    phi = _subset_dp(costs, rhos, miss_penalty)
    if allowed is not None:
        bad = (np.arange(k)[None, :] &
               ~np.asarray(allowed, np.int64)[:, None]) != 0
        phi[bad] = np.inf
    # np.argmin returns the FIRST minimal subset in ascending-mask order
    return _bits_to_masks(np.argmin(phi, axis=1), n)


def _check_table_n(n: int, name: str) -> None:
    if n > MAX_EXHAUSTIVE_TABLE_CACHES:
        raise ValueError(
            f"{name}() limited to n <= {MAX_EXHAUSTIVE_TABLE_CACHES}")


def exhaustive_tables(costs, pi, nu, miss_penalty, *, fno: bool = False,
                      device=None) -> torch.Tensor:
    """[V, 2^n] int64 selection bitmasks over ALL indication patterns for a
    batch of V view versions, with the EXHAUSTIVE subroutine
    (n <= ``MAX_EXHAUSTIVE_TABLE_CACHES``); ``fno=True`` restricts
    candidates to positive-indication caches.

    Builds the [V * 2^n, n] rho rows on ``device`` (the tensors' own
    device when they are tensors) and hands them to the fused
    ``subset_argmin`` in one call — the kernel for CUDA tensors, which
    never materialises the [rows, 2^n] matrix, its plain version (which
    bounds its own working set) on the CPU.  The result is an int64
    tensor there."""
    dev = tensor_device(pi, device)
    pi = torch.atleast_2d(f64(pi, dev))
    nu = torch.atleast_2d(f64(nu, dev))
    _check_table_n(pi.shape[1], "exhaustive_tables")
    return _exhaustive_argmin(costs, pi, nu, f64(miss_penalty, dev), fno,
                              cells=1).reshape(pi.shape[0], -1)


def _exhaustive_argmin(costs, pi: torch.Tensor, nu: torch.Tensor,
                       mp: torch.Tensor, fno: bool, cells: int
                       ) -> torch.Tensor:
    """[cells * V * 2^n] subset bitmasks: the (version x pattern) rho rows
    repeated once per cell, each row under ``mp`` (scalar, or one penalty
    per row), through one ``subset_argmin`` call."""
    from repro_torch.kernels.subsetdp.ops import subset_argmin
    rhos = _pattern_rhos(pi, nu)
    if cells > 1:
        rhos = rhos.repeat(cells, 1)
    k = 1 << pi.shape[1]
    allowed = None
    if fno:                        # pattern p's candidates are its own bits
        allowed = torch.arange(rhos.shape[0], dtype=I64,
                               device=rhos.device) % k
    return subset_argmin(costs, rhos, mp, allowed=allowed)


def exhaustive_tables_cells(costs, pi, nu, penalties, *, fno: bool = False,
                            device=None) -> torch.Tensor:
    """[C, V, 2^n] stacked exhaustive tables for C decision cells sharing
    one (costs, fno) but differing in miss penalty — the cross-cell
    prefetch of a penalty-axis sweep.  Every (cell, version, pattern) row
    goes to the kernel with its own penalty in a [rows] vector, so each
    cell's slice is bit-identical to its per-cell :func:`exhaustive_tables`
    call (the penalty only seeds the product)."""
    dev = tensor_device(pi, device)
    pi = torch.atleast_2d(f64(pi, dev))
    nu = torch.atleast_2d(f64(nu, dev))
    v, n = pi.shape
    _check_table_n(n, "exhaustive_tables_cells")
    penalties = f64(penalties, dev)
    c = penalties.shape[0]
    mp = penalties.repeat_interleave(v << n)
    return _exhaustive_argmin(costs, pi, nu, mp, fno,
                              cells=c).reshape(c, v, 1 << n)


def _argmin_geometric_batched(m_eff, rho, r_max) -> np.ndarray:
    """Vectorised float64 mirror of the scalar
    :func:`repro_torch.core.policies._argmin_geometric`: same edge-case
    branches, same {0, 1, floor(r*), ceil(r*), r_max} candidate shortlist
    scanned in ascending order with the same EPS strict-improvement
    dead-band.  All inputs broadcast to [B]."""
    m_eff, rho, r_max = np.broadcast_arrays(
        np.asarray(m_eff, np.float64), np.asarray(rho, np.float64),
        np.asarray(r_max, np.int64))
    out = np.zeros(m_eff.shape, np.int64)
    pos = r_max > 0
    tiny = pos & (rho <= EPS)
    out[tiny & (m_eff > 1.0)] = 1
    mid = pos & (rho > EPS) & (rho < 1.0 - EPS)
    if not mid.any():
        return out
    m = m_eff[mid]
    r = rho[mid]
    rmax = r_max[mid]
    # continuous optimum: r* = ln(m_eff * ln(1/rho)) / ln(1/rho)
    l = np.log(1.0 / r)
    r_cont = np.log(np.maximum(m * l, EPS)) / l
    cand = np.stack([np.zeros_like(r_cont), np.ones_like(r_cont),
                     np.floor(r_cont), np.ceil(r_cont),
                     rmax.astype(np.float64)], axis=1)
    cand = np.sort(cand, axis=1)          # the scalar's ascending scan
    ok = (cand >= 0.0) & (cand <= rmax[:, None].astype(np.float64))
    val = cand + m[:, None] * r[:, None] ** cand
    best_r = np.zeros(m.shape, np.float64)
    best_v = m.copy()                     # r = 0 baseline
    for s in range(cand.shape[1]):        # duplicates can't strictly improve
        imp = ok[:, s] & (val[:, s] < best_v - EPS)
        best_r = np.where(imp, cand[:, s], best_r)
        best_v = np.where(imp, val[:, s], best_v)
    out[mid] = best_r.astype(np.int64)
    return out


def hocs_fna_batched(n_x, n, pi, nu, miss_penalty
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 1, batched over requests (homogeneous parameters): the
    float64 NumPy mirror of the scalar :func:`repro_torch.core.hocs_fna`
    (same candidate shortlist and EPS dead-band).  ``n_x``: [B] positive-
    indication counts; ``pi``/``nu``/``miss_penalty``: scalars or [B].
    Returns (r0, r1) int64 [B]."""
    n_x = np.asarray(n_x, np.int64)
    pi, nu, m, n_x = np.broadcast_arrays(
        np.asarray(pi, np.float64), np.asarray(nu, np.float64),
        np.asarray(miss_penalty, np.float64), n_x)
    r1 = _argmin_geometric_batched(m, pi, n_x)
    residual = m * pi ** r1
    r0 = np.where(residual > 1.0,
                  _argmin_geometric_batched(residual, nu, n - n_x), 0)
    return r0.astype(np.int64), r1


def hocs_selection_tables_cells(pi_v, nu_v, penalties) -> np.ndarray:
    """[C, V, 2^n] int64 HOCS selection bitmasks for C decision cells (one
    miss penalty each) sharing one view history, mirroring the reference
    loop exactly: pooled estimates are LEFT-TO-RIGHT sums over caches
    (computed once — they are penalty-independent), the (r0*, r1*) grid is
    one :func:`hocs_fna_batched` call over every (cell, version, popcount)
    triple, and row (c, v, p) accesses the r1* lowest-index positive-
    indication caches plus the r0* lowest-index negative ones."""
    pi_v = np.atleast_2d(np.asarray(pi_v, np.float64))
    nu_v = np.atleast_2d(np.asarray(nu_v, np.float64))
    penalties = np.asarray(penalties, np.float64)
    c = penalties.shape[0]
    v, n = pi_v.shape
    k = 1 << n
    acc_pi = np.zeros(v, np.float64)
    acc_nu = np.zeros(v, np.float64)
    for j in range(n):                    # left-to-right, like sum(list)
        acc_pi = acc_pi + pi_v[:, j]
        acc_nu = acc_nu + nu_v[:, j]
    pi_h = acc_pi / n
    nu_h = acc_nu / n
    # (r0*, r1*) depends on the pattern only through its popcount
    nx = np.arange(n + 1, dtype=np.int64)
    r0g, r1g = hocs_fna_batched(
        np.tile(nx, c * v), n,
        np.tile(np.repeat(pi_h, n + 1), c),
        np.tile(np.repeat(nu_h, n + 1), c),
        np.repeat(penalties, v * (n + 1)))
    r0g = r0g.reshape(c * v, n + 1)
    r1g = r1g.reshape(c * v, n + 1)
    bits = ((np.arange(k)[:, None] >> np.arange(n)[None, :]) & 1
            ).astype(np.int64)                                    # [K, n]
    pow2 = (1 << np.arange(n)).astype(np.int64)
    rank_pos = np.cumsum(bits, axis=1)      # 1-based rank among set bits
    rank_neg = np.cumsum(1 - bits, axis=1)
    # low_set[p, r] = mask of the r lowest-index positive caches of p
    low_set = np.stack([(bits * (rank_pos <= r)) @ pow2
                        for r in range(n + 1)], axis=1)           # [K, n+1]
    low_clr = np.stack([((1 - bits) * (rank_neg <= r)) @ pow2
                        for r in range(n + 1)], axis=1)
    popc = bits.sum(axis=1)                                       # [K]
    rows = np.arange(k)[None, :]
    sel = low_set[rows, r1g[:, popc]] | low_clr[rows, r0g[:, popc]]
    return sel.astype(np.int64).reshape(c, v, k)


def hocs_selection_tables(pi_v, nu_v, miss_penalty) -> np.ndarray:
    """[V, 2^n] int64 HOCS selection bitmasks — the single-cell view of
    :func:`hocs_selection_tables_cells` (same code path)."""
    return hocs_selection_tables_cells(
        pi_v, nu_v, [float(miss_penalty)])[0]
