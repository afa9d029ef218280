#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits non-zero
(printing no result) without a CUDA device or outside a checkout.
Phases, each failing the run on any mismatch:

  1. build the CUDA kernels, one nvcc per source, all started together
     (``src/repro_torch/kernels/subsetdp/csrc/subsetdp.cu`` and
     ``kernels/bloom/csrc/bloom.cu``, sm_90a), and print the card;
  2. hold the kernel against its plain PyTorch version on the card:
     ``subset_prod`` byte for byte at n in {4, 8, 12} (rho in {0, 1},
     ragged row counts), ``subset_argmin`` exactly with and without
     ``allowed`` and with per-row penalties, a seeded sample of n = 12
     rows;
  3. the slice at paper scale (1M gradle requests, cache_size 10,000,
     update_interval 1,000, bpe 14, est_interval 50, M = 100):
     (a) 3 caches, DS_PGM, policies pi/fno/fna/fna_cal — DS_PGM tables on
     the card against the CPU row by row (any difference must lie in the
     1e-12 near-tie dead-band); (b) 8 caches, the exhaustive subroutine,
     policies fno/fna/pi — the main path through the kernel (launch
     counts read around it), its results equal to the same run on the
     CPU field for field; phase times are the engine's own
     (``RunReport``); then the kernel's and plain version's times on the
     main path's two table builds (fna, and fno with ``allowed``);
  4. the router tier, its launch counts read around the main drive:
     (c1) the paper shape — 8 indicators of 10,000 keys at bpe 14
     (m = 140,000 bits, k = 10) probed with all 1M gradle requests;
     (c2) the fleet shape — 16 nodes of capacity 40M at bpe 14 (70 MB
     indicators, 1.12 GB of bitmaps), advertised content shifted from the
     current one by 10% churn, 2^20 keys probed against the stale and the
     fresh bitmaps, the measured (q, fp, fn) fed with the indications into
     ``cs_fna_batched``/``cs_fno_batched`` on the card; the kernel equals
     its plain version on every output, fresh members show no false
     negative; (c3) slice (b)'s own indication patterns and end-of-run
     estimates decided on the card and on the CPU at float32 and float64,
     differing rows only inside the stated dead-bands; the kernel's and
     plain version's times at (c1) and (c2); and the ``--replay`` serving
     entry point once per regime;
  5. golden on the card: ``exhaustive_small`` (its fna_cal speculation
     tables through the kernel too) and ``fig4_gradle`` equal to
     ``tests/golden/*.json`` bit for bit.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object describing the kernels of the main path, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): fp64 without tensor cores, HBM3
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12
#: the paper-scale setup (benchmarks/paper_figs.py _scale(full=True))
PAPER = dict(cache_size=10_000, update_interval=1_000, bpe=14.0,
             est_interval=50, miss_penalty=100.0, seed=0)
N_REQUESTS = 1_000_000
DEAD_BAND = 1e-12
#: float32 router decisions: relative gap between the two best prefix
#: costs inside which card and CPU may choose differently.  float32 keeps
#: 24 bits (6e-8 relative); CPU and CUDA ``log``/``exp`` may differ by ~2
#: ulps each, and a prefix cost folds up to 8 such terms, so ~1e-6; ten
#: times that leaves margin without hiding a real disagreement.
DEAD_BAND_F32 = 1e-5
#: H100 SXM integer issue: 132 SMs x 64 INT32 lanes x 1.98 GHz boost —
#: derived from the SM layout; the data sheet gives no INT32 rate
PEAK_INT32_OPS = 132 * 64 * 1.98e9
L2_BYTES = 50e6
#: the router's indicator budget (bits per element) and k = optimal_k(14)
ROUTER_BPE = 14.0
#: (c1) the paper shape: n indicators of ``keys`` trace keys each
PAPER_ROUTER = dict(n=8, keys=10_000)
#: (c2) benchmarks/run.py router_bench's 16-node fleet at capacity 40M,
#: 10% churn between the advertised and the current content, 2^20 keys
FLEET = dict(n=16, capacity=40_000_000, churn=4_000_000, batch=1 << 20,
             miss_penalty=100.0)


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls after one warm-up,
    timed with CUDA events."""
    import torch
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def phase_build(card: str) -> float:
    """Every kernel source built at once (one nvcc each), then loaded."""
    from repro_torch.kernels.bloom import build as bloom_build
    from repro_torch.kernels.subsetdp import build as subsetdp_build
    builds = (subsetdp_build, bloom_build)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b.build(verbose=True), builds))
    for b in builds:
        b.load()
    secs = time.perf_counter() - t0
    names = ", ".join(f"{b.SOURCE.name} -> {b.library_path().name}"
                      for b in builds)
    print(f"[build] {names} in {secs:.2f} s ({card})")
    return secs


def _instance(rng, n, b):
    import numpy as np
    costs = rng.uniform(0.05, 5.0, n)
    rhos = rng.uniform(0.0, 1.0, (b, n))
    rhos[0] = 0.0
    rhos[1 % b] = 1.0
    if b > 2:
        rhos[2] = 0.5               # exact ties across subset sizes
        rhos[3 % b, : n // 2] = 0.0
        rhos[3 % b, n // 2:] = 1.0
    return costs, rhos, float(rng.uniform(1.5, 1000.0))


def phase_kernel_checks(dev) -> None:
    """Kernel vs plain version on the card (comparison launches; they do
    not count towards the main path)."""
    import numpy as np
    import torch
    from repro_torch.core.batched import _subset_dp
    from repro_torch.kernels.subsetdp import ops, ref
    rng = np.random.default_rng(2024)
    for n in (4, 8, 12):
        for b in (3, 1003):
            costs, rhos, M = _instance(rng, n, b)
            r = torch.as_tensor(rhos, device=dev)
            mp = torch.as_tensor([M], dtype=torch.float64, device=dev)
            got = ops.subset_prod(r, M)
            want = ref.subset_prod_ref(r, mp)
            check(got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes(),
                  f"subset_prod != plain at n={n} B={b}")
            check(ops.subset_dp(costs, r, M).cpu().numpy().tobytes() ==
                  _subset_dp(costs, rhos, M).tobytes(),
                  f"subset_dp != host oracle at n={n} B={b}")
            cost = ops.subset_costs(costs, n, dev)
            per_row = rng.uniform(1.5, 1000.0, b)
            for pen in (M, per_row):
                pm = torch.as_tensor(np.atleast_1d(pen), dtype=torch.float64,
                                     device=dev)
                for allowed in (None, torch.as_tensor(
                        rng.integers(0, 1 << n, b), device=dev)):
                    got = ops.subset_argmin(costs, r, pen, allowed=allowed)
                    want = ref.subset_argmin_ref(cost, r, pm, allowed)
                    check(torch.equal(got, want),
                          f"subset_argmin != plain at n={n} B={b} "
                          f"per_row={np.ndim(pen) > 0} "
                          f"allowed={allowed is not None}")
    # n = 12 at a larger row count: a seeded sample of rows vs plain
    n, b = 12, 20_000
    costs, rhos, M = _instance(rng, n, b)
    r = torch.as_tensor(rhos, device=dev)
    allowed = torch.as_tensor(rng.integers(0, 1 << n, b), device=dev)
    got = ops.subset_argmin(costs, r, M, allowed=allowed)
    rows = torch.as_tensor(np.sort(rng.choice(b, 500, replace=False)),
                           device=dev)
    want = ref.subset_argmin_ref(
        ops.subset_costs(costs, n, dev), r[rows],
        torch.as_tensor([M], dtype=torch.float64, device=dev),
        allowed[rows])
    check(torch.equal(got[rows], want), "subset_argmin n=12 sample != plain")
    print("[kernel] subset_prod bytes-equal and subset_argmin exact vs the "
          "plain version at n in {4, 8, 12}, B in {3, 1003}, scalar and "
          "per-row penalties, with/without allowed; n=12 B=20000 sample "
          "of 500 rows exact")


def _dead_band_rows(costs, rhos, M, allowed):
    """Relative gap between the two best DS_PGM prefix costs per row
    (host NumPy, the scalar path's arithmetic order)."""
    import numpy as np
    r = np.clip(rhos, 1e-12, 1.0 - 1e-12)
    key = costs[None, :] / -np.log(r)
    c_b = np.broadcast_to(costs, r.shape)
    if allowed is not None:
        key = np.where(allowed, key, np.inf)
        c_b = np.where(allowed, c_b, np.inf)
        r = np.where(allowed, r, 1.0)
    order = np.argsort(key, axis=1, kind="stable")
    csum = np.cumsum(np.take_along_axis(c_b, order, 1), axis=1)
    lprod = np.cumsum(np.log(np.take_along_axis(r, order, 1)), axis=1)
    phi = np.concatenate([np.full((r.shape[0], 1), M),
                          csum + M * np.exp(lprod)], axis=1)
    two = np.sort(phi, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.maximum(np.abs(two[:, 0]), 1.0)


def _compare_ds_pgm_tables(st, cfg) -> None:
    """DS_PGM tables on the card vs on the CPU, row by row."""
    import numpy as np
    import torch
    from repro_torch.core.batched import selection_tables
    n = st.n
    k = 1 << n
    bits = ((np.arange(k)[:, None] >> np.arange(n)[None, :]) & 1) > 0
    rhos = np.where(bits[None], st.pi_v[:, None, :],
                    st.nu_v[:, None, :]).reshape(-1, n)
    costs = np.asarray(cfg.costs, np.float64)
    for fno in (False, True):
        d = st.device_arrays()
        card = selection_tables(costs, d["pi"], d["nu"], cfg.miss_penalty,
                                fno=fno).cpu().numpy().reshape(-1, n)
        host = selection_tables(costs, torch.as_tensor(st.pi_v),
                                torch.as_tensor(st.nu_v), cfg.miss_penalty,
                                fno=fno).numpy().reshape(-1, n)
        diff = np.flatnonzero((card != host).any(axis=1))
        gaps = _dead_band_rows(costs, rhos[diff], cfg.miss_penalty,
                               np.tile(bits, (st.pi_v.shape[0], 1))[diff]
                               if fno else None) if diff.size else \
            np.zeros(0)
        print(f"[slice a] DS_PGM {'fno' if fno else 'fna'} tables card vs "
              f"CPU: {diff.size} of {card.shape[0]} rows differ"
              + (f", max relative prefix-cost gap {gaps.max():.3e}"
                 if diff.size else ""))
        check(not np.any(gaps > DEAD_BAND),
              f"DS_PGM rows differ outside the {DEAD_BAND} dead-band")


def _run_main_path(trace, cfg, policies, dev):
    """``run_policies`` on the card with a ``RunReport`` (the engine's own
    phase times, each ended by a device sync); returns (results, report,
    wall seconds)."""
    from repro_torch.cachesim import RunReport, run_policies
    report = RunReport()
    t0 = time.perf_counter()
    res = run_policies(trace, cfg, policies, device=dev, report=report)
    sync()
    return res, report, time.perf_counter() - t0


def _phases(report) -> str:
    return json.dumps({"phase1_s": report.phase1_s,
                       "prefetch_s": report.prefetch_s,
                       "phase2_s": report.phase2_s,
                       "phase3_s": report.phase3_s})


def _print_results(tag, res, policies, card):
    for p in policies:
        print(f"[{tag}] {p}: mean_cost {res[p].mean_cost!r} "
              f"hit_ratio {res[p].hit_ratio!r} ({card})")


def phase_slice(dev, card: str):
    """Phase 3: both paper-scale configurations; returns the kernel
    record inputs measured on (b)'s main path."""
    from repro_torch.cachesim import SimConfig, get_trace, run_policies
    from repro_torch.kernels.subsetdp import ops
    trace = get_trace("gradle", N_REQUESTS, seed=0)

    # (a) 3 caches, DS_PGM
    cfg_a = SimConfig(n_caches=3, costs=(1.0, 2.0, 3.0), alg="ds_pgm",
                      **PAPER)
    pol_a = ("pi", "fno", "fna", "fna_cal")
    res_a, rep_a, total_a = _run_main_path(trace, cfg_a, pol_a, dev)
    st_a = rep_a.system
    print(f"[slice a] n=3 ds_pgm: V={st_a.pi_v.shape[0]} table rows="
          f"{st_a.pi_v.shape[0] << 3}; run_policies {total_a:.3f} s; "
          f"{_phases(rep_a)} ({card})")
    _print_results("slice a", res_a, pol_a, card)
    _compare_ds_pgm_tables(st_a, cfg_a)

    # (b) 8 caches, the exhaustive subroutine: the kernel's main path
    cfg_b = SimConfig(n_caches=8, costs=(1.0, 2.0, 3.0, 1.5) * 2,
                      alg="exhaustive", **PAPER)
    pol_b = ("fno", "fna", "pi")
    ops.reset_launches()
    res_b, rep_b, total_b = _run_main_path(trace, cfg_b, pol_b, dev)
    launches = dict(ops.LAUNCHES)
    print(f"[slice b] main path kernel launches: {json.dumps(launches)}")
    check(launches["subset_argmin"] > 0,
          "the exhaustive main path launched no subset_argmin kernel")
    st_b = rep_b.system
    v_b = st_b.pi_v.shape[0]
    print(f"[slice b] n=8 exhaustive: V={v_b} table rows={v_b << 8}; "
          f"run_policies {total_b:.3f} s; {_phases(rep_b)} ({card})")
    _print_results("slice b", res_b, pol_b, card)
    t0 = time.perf_counter()
    res_cpu = run_policies(trace, cfg_b, pol_b, device="cpu")
    cpu_s = time.perf_counter() - t0
    for p in pol_b:
        check(dataclasses.asdict(res_b[p]) == dataclasses.asdict(res_cpu[p])
              and res_b[p].to_dict() == res_cpu[p].to_dict(),
              f"(b) {p}: card result != CPU result")
    print(f"[slice b] card results == CPU results for {pol_b} (CPU run "
          f"{cpu_s:.3f} s on the host's cores)")
    return st_b, cfg_b, launches


def _popcount(x, n: int):
    import torch
    return ((x[:, None] >> torch.arange(n, device=x.device)) & 1).sum(1)


def argmin_work(rhos, allowed):
    """(operations, bytes) that ``subset_argmin`` needs on these inputs:
    per allowed mask one multiply (a subset's product is its prefix's
    times one rho, mask 0 needs none), one add and one compare — only the
    subsets of ``allowed[b]`` where it is given; every input read once
    (rhos, the 2^n cost vector, M, allowed) and the [B] output written
    once."""
    b, n = rhos.shape
    k = 1 << n
    masks = b * k if allowed is None else \
        int((1 << _popcount(allowed, n)).sum())
    ops = 3 * masks - b
    nbytes = rhos.numel() * 8 + k * 8 + 8 + b * 8 + \
        (0 if allowed is None else b * 8)
    return ops, nbytes


def prod_work(rhos):
    """(operations, bytes) for ``subset_prod``: one multiply per non-empty
    mask; rhos and M read once, the [B, 2^n] output written once."""
    b, n = rhos.shape
    k = 1 << n
    return b * (k - 1), rhos.numel() * 8 + 8 + b * k * 8


def bound(ops: int, nbytes: int, peak_ops: float = PEAK_FP64_FLOPS):
    """(least milliseconds, what bounds it) for this much work at
    ``peak_ops`` operations per second."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel_times(st, cfg, launches, card: str):
    """The kernel against its plain version on (b)'s main-path inputs: the
    [V * 256, 8] rho rows of the fna table (no ``allowed``) and of the
    fno table (CS_FNO ``allowed`` = each row's pattern), the two launches
    the main path makes.  The record's times and bound are for the two
    launches together."""
    import torch
    from repro_torch.core.batched import _pattern_rhos
    from repro_torch.kernels.subsetdp import ops, ref
    d = st.device_arrays()
    rhos = _pattern_rhos(d["pi"], d["nu"]).contiguous()
    b, n = rhos.shape
    dev = rhos.device
    costs = list(cfg.costs)
    M = cfg.miss_penalty
    cost = ops.subset_costs(costs, n, dev)
    mp = torch.as_tensor([M], dtype=torch.float64, device=dev)
    before = dict(ops.LAUNCHES)
    total = dict(ms=0.0, plain_ms=0.0, ops=0, nbytes=0, err=0)
    for policy, allowed in (("fna", None),
                            ("fno", torch.arange(b, device=dev) % (1 << n))):
        kern = ops.subset_argmin(costs, rhos, M, allowed=allowed)
        plain = ref.subset_argmin_ref(cost, rhos, mp, allowed)
        err = int((kern - plain).abs().max())
        check(err == 0, f"subset_argmin != plain on (b)'s {policy} table")
        ms = cuda_ms(lambda: ops.subset_argmin(costs, rhos, M,
                                               allowed=allowed), 5)
        plain_ms = cuda_ms(lambda: ref.subset_argmin_ref(cost, rhos, mp,
                                                         allowed), 2)
        n_ops, nbytes = argmin_work(rhos, allowed)
        bound_ms, by = bound(n_ops, nbytes)
        print(f"[times] subset_argmin {policy} table B={b} n={n}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({by}; {n_ops} fp64 operations, {nbytes} bytes) ({card})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("ops", n_ops),
                         ("nbytes", nbytes)):
            total[key] += val
        total["err"] = max(total["err"], err)
    bound_ms, by = bound(total["ops"], total["nbytes"])
    print(f"[times] subset_argmin, both launches: kernel {total['ms']:.4f} "
          f"ms, plain {total['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}) ({card})")
    # subset_prod (validation counterpart, off the main path) at a slice
    # of the same rows: its [rows, 2^n] output is what the fused kernel
    # keeps out of device memory
    sub = rhos[: 1 << 18]
    prod_ms = cuda_ms(lambda: ops.subset_prod(sub, M), 5)
    prod_plain_ms = cuda_ms(lambda: ref.subset_prod_ref(sub, mp), 2)
    p_bound, p_by = bound(*prod_work(sub))
    print(f"[times] subset_prod B={sub.shape[0]} n={n}: kernel "
          f"{prod_ms:.4f} ms, plain {prod_plain_ms:.4f} ms, bound "
          f"{p_bound:.4f} ms ({p_by}) ({card})")
    check(dict(ops.LAUNCHES) != before, "timing runs launched no kernel")
    return {
        "name": "subsetdp.subset_argmin", "route": "cuda",
        "source": "src/repro_torch/kernels/subsetdp/csrc/subsetdp.cu",
        "replaces": "src/repro/kernels/subsetdp/subsetdp.py:41",
        "launches": launches["subset_argmin"], "max_abs_err": total["err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
    }


def _probe_needs(bits, keys, k: int, seeds=None):
    """What ``bloom_probe`` needs on this run's data (plain torch on the
    inputs' device): the probes each (key, cache) makes up to its first
    zero bit, and the distinct 32-byte bitmap sectors those probes touch."""
    import torch
    from repro_torch.kernels.bloom import ref
    n, mbytes = bits.shape
    seeds = list(range(n)) if seeds is None else seeds
    h2 = ref.hash_h2(ref.as_u32(keys))
    probes, sectors = 0, []
    for j in range(n):
        idx = ref.hash_idx(keys, k, mbytes * 8, seeds[j], h2=h2)
        bit = (bits[j][idx >> 3].to(torch.int64) >> (idx & 7)) & 1
        need = torch.cumprod(torch.cat([torch.ones_like(bit[:, :1]),
                                        bit[:, :-1]], dim=1), dim=1) > 0
        probes += int(need.sum())
        sectors.append(((j * mbytes + (idx >> 3)) >> 5)[need])
    return probes, int(torch.unique(torch.cat(sectors)).numel())


def bloom_work(bits, keys, k: int, seeds=None):
    """(operations, bytes) that ``bloom_probe`` needs on these inputs.
    Operations as ``kernels/bloom/ref.py``'s formula counts them, one per
    operator: 10 per key for h2 (xor, mix32's three xor-shifts and two
    multiplies, or), 9 per (key, cache) for h1, and 8 per probe made up to
    the first zero bit (multiply, add, modulo, shift, mask, shift, mask,
    and).  Bytes: keys and seed words read once, the [B, n] int8 output
    written once, and the bitmaps — each byte once where they all fit in
    L2, else one 32-byte sector per distinct sector the needed probes
    touch."""
    n, _ = bits.shape
    b = keys.shape[0]
    probes, sectors = _probe_needs(bits, keys, k, seeds)
    ops = 10 * b + 9 * b * n + 8 * probes
    bitmap = bits.numel() if bits.numel() <= L2_BYTES else 32 * sectors
    nbytes = keys.numel() * keys.element_size() + 8 * n + b * n + bitmap
    return ops, nbytes


def _fleet_bitmaps(dev, shift: int):
    """[n, m_bytes] fleet bitmaps: node j holds the keys
    [j*C + shift, (j+1)*C + shift), hashed with seed j."""
    import torch
    from repro_torch.core import optimal_k
    from repro_torch.kernels.bloom import build_indicator
    n, cap = FLEET["n"], FLEET["capacity"]
    m = int(ROUTER_BPE * cap)
    bits = torch.empty((n, m // 8), dtype=torch.uint8, device=dev)
    for j in range(n):
        keys = torch.arange(j * cap + shift, (j + 1) * cap + shift,
                            device=dev)
        bits[j] = build_indicator(keys, m, optimal_k(ROUTER_BPE), seed=j)
    return bits


def _decide_fleet(ind, member, dev, card: str) -> None:
    """The fleet's measured (q, fp, fn), fed with the stale indications
    into the batched CS_FNA / CS_FNO decisions on the card (float32, as
    the reference's router_bench runs them)."""
    import numpy as np
    import torch
    from repro_torch.core.batched import cs_fna_batched, cs_fno_batched
    pos = ind > 0
    fn = ((~pos) & member).sum(0).double() / member.sum(0)
    fp = (pos & ~member).sum(0).double() / (~member).sum(0)
    q = pos.double().mean(0)
    check(bool((fn > 0).all() and (fp > 0).all()),
          "(c2) stale indicators show no false negatives or positives")
    fmt = lambda x: json.dumps([float(v) for v in x.cpu()])  # noqa: E731
    print(f"[router c2] measured per node: fp {fmt(fp)} fn {fmt(fn)} "
          f"q {fmt(q)}")
    costs = torch.as_tensor(np.random.default_rng(0).uniform(
        1, 3, FLEET["n"]), dtype=torch.float32, device=dev)
    views = [x.to(torch.float32) for x in (q, fp, fn)]
    M = FLEET["miss_penalty"]
    for name, policy in (("fna", cs_fna_batched), ("fno", cs_fno_batched)):
        sel = policy(ind, costs, *views, M)
        neg = int((sel & ~pos).sum())
        total = int(sel.sum())
        hit = (sel & member).any(dim=1)
        cost = (sel * costs).sum(dim=1) + M * (~hit)
        if name == "fno":
            check(neg == 0, "(c2) CS_FNO accessed a negative-indication cache")
        print(f"[router c2] {name}: {total} accesses, {neg} to "
              f"negative-indication caches (share "
              f"{neg / max(total, 1)!r}), hit ratio "
              f"{float(hit.double().mean())!r}, mean cost "
              f"{float(cost.double().mean())!r} ({card})")


def _decisions_vs_cpu(st, cfg, dev) -> None:
    """(c3): slice (b)'s own indication patterns and end-of-run (q, fp,
    fn) decided on the card and on the CPU at float32 and float64; a row
    that differs must lie in the dtype's dead-band."""
    import numpy as np
    import torch
    from repro_torch.core.batched import (cs_fna_batched, cs_fno_batched,
                                          rho_matrix)
    ind = st.ind_all[-(1 << 20):].astype(np.int8)
    views = (np.asarray(cfg.costs, np.float64),
             np.asarray([s["q"] for s in st.final_state["q"]], np.float64),
             st.fp_v[-1], st.fn_v[-1])
    M = cfg.miss_penalty
    cpu = torch.device("cpu")
    for dtype, band in ((torch.float32, DEAD_BAND_F32),
                        (torch.float64, DEAD_BAND)):
        args = {d: [torch.as_tensor(ind, device=d)] +
                [torch.as_tensor(x, dtype=dtype, device=d) for x in views]
                for d in (dev, cpu)}
        for name, policy in (("fna", cs_fna_batched),
                             ("fno", cs_fno_batched)):
            card_sel = policy(*args[dev], M).cpu().numpy()
            host_sel = policy(*args[cpu], M).numpy()
            diff = np.flatnonzero((card_sel != host_sel).any(axis=1))
            gaps = np.zeros(0)
            if diff.size:
                rhos = rho_matrix(args[cpu][0][diff], *args[cpu][2:])
                gaps = _dead_band_rows(views[0], rhos.double().numpy(), M,
                                       ind[diff] > 0 if name == "fno"
                                       else None)
            print(f"[router c3] {name} {str(dtype)[6:]}: {diff.size} of "
                  f"{ind.shape[0]} rows differ card vs CPU"
                  + (f", max relative prefix-cost gap {gaps.max():.3e}"
                     if diff.size else "") + f" (dead-band {band})")
            check(not np.any(gaps > band),
                  f"(c3) {name} {dtype}: rows differ outside the dead-band")


def phase_router(dev, st, cfg, card: str):
    """Phase 4: the router tier's device path — Bloom probe, then decide —
    at the paper shape (c1) and the fleet shape (c2), then (c3); returns
    the Bloom kernel's record."""
    import numpy as np
    import torch
    from repro_torch.cachesim import get_trace
    from repro_torch.core import optimal_k
    from repro_torch.kernels import bloom
    from repro_torch.kernels.bloom import ref
    from repro_torch.kernels.subsetdp import ops as subsetdp_ops
    k = optimal_k(ROUTER_BPE)
    rng = np.random.default_rng(0)
    trace = get_trace("gradle", N_REQUESTS, seed=0)
    n1, per = PAPER_ROUTER["n"], PAPER_ROUTER["keys"]
    members1 = rng.permutation(np.unique(trace))[: n1 * per].reshape(n1, per)
    keys1 = torch.as_tensor(trace, device=dev)
    n2, cap, d = FLEET["n"], FLEET["capacity"], FLEET["churn"]
    keys2 = torch.as_tensor(rng.integers(0, n2 * cap + d, FLEET["batch"]),
                            device=dev)

    # the main drive, its launch counts read around it
    subsetdp_ops.reset_launches()
    bloom.reset_launches()
    t0 = time.perf_counter()
    bits1 = torch.stack([bloom.build_indicator(
        torch.as_tensor(members1[j], device=dev), int(ROUTER_BPE * per), k,
        seed=j) for j in range(n1)])
    ind1 = bloom.bloom_probe(bits1, keys1, k=k)
    stale, fresh = _fleet_bitmaps(dev, 0), _fleet_bitmaps(dev, d)
    ind2 = bloom.bloom_probe(stale, keys2, k=k)
    ind2_fresh = bloom.bloom_probe(fresh, keys2, k=k)
    member = (torch.where(keys2 >= d, (keys2 - d) // cap, -1)[:, None]
              == torch.arange(n2, device=dev)[None, :])
    _decide_fleet(ind2, member, dev, card)
    sync()
    drive_s = time.perf_counter() - t0
    launches = {**bloom.LAUNCHES, **subsetdp_ops.LAUNCHES}
    print(f"[router] main drive {drive_s:.3f} s; kernel launches "
          f"{json.dumps(launches)} ({card})")
    check(bloom.LAUNCHES["bloom_probe"] > 0,
          "the router path launched no bloom_probe kernel")

    # (c1), (c2): kernel against its plain version on every output
    err = 0
    cases = (("c1 paper", bits1, keys1), ("c2 fleet stale", stale, keys2),
             ("c2 fleet fresh", fresh, keys2))
    for (tag, bits, keys), got in zip(cases, (ind1, ind2, ind2_fresh)):
        want = ref.bloom_probe_ref(bits, keys, k)
        e = int((got.to(torch.int16) - want).abs().max())
        err = max(err, e)
        check(e == 0, f"({tag}) bloom_probe != plain")
        print(f"[router {tag}] n={bits.shape[0]} m_bytes={bits.shape[1]} "
              f"k={k} B={keys.shape[0]}: kernel == plain on all "
              f"{got.numel()} outputs; positive share "
              f"{float(got.double().mean())!r}")
    for j in range(n1):
        mem = torch.isin(keys1, torch.as_tensor(members1[j], device=dev))
        check(bool(ind1[mem, j].all()), "(c1) a member answered 0")
    check(bool(ind2_fresh[member].all()),
          "(c2) a fresh indicator showed a false negative")
    print(f"[router c2] fresh indicators: 0 false negatives over "
          f"{int(member.sum())} member probes; stale: "
          f"{int((ind2[member] == 0).sum())} false negatives")
    _decisions_vs_cpu(st, cfg, dev)

    # times at (c1) and (c2), beside the bound of this run's inputs
    total = dict(ms=0.0, plain_ms=0.0, ops=0, nbytes=0)
    for tag, bits, keys in cases:
        ms = cuda_ms(lambda: bloom.bloom_probe(bits, keys, k=k), 10)
        plain_ms = cuda_ms(lambda: ref.bloom_probe_ref(bits, keys, k), 2)
        n_ops, nbytes = bloom_work(bits, keys, k)
        bound_ms, by = bound(n_ops, nbytes, PEAK_INT32_OPS)
        print(f"[times] bloom_probe {tag} B={keys.shape[0]} "
              f"n={bits.shape[0]} m_bytes={bits.shape[1]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({by}; {n_ops} int32 operations, {nbytes} bytes) "
              f"({card})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("ops", n_ops),
                         ("nbytes", nbytes)):
            total[key] += val
    bound_ms, by = bound(total["ops"], total["nbytes"], PEAK_INT32_OPS)
    print(f"[times] bloom_probe, the three launches: kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}) ({card})")
    return {
        "name": "bloom.bloom_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/bloom/csrc/bloom.cu",
        "replaces": "src/repro/kernels/bloom/bloom.py:30",
        "launches": launches["bloom_probe"], "max_abs_err": err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
    }


def phase_serve() -> None:
    """The serving entry point (host-only router replay) once per regime."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serving import REGIMES
    for regime in sorted(REGIMES):
        rc = serve_main(["--replay", "--mode", "sequential", "--regime",
                         regime, "--requests", "4000"])
        check(rc == 0, f"serve --replay {regime} exited {rc}")


#: golden scenarios re-run on the card, configs as the scenario registry
#: defines them (tests/golden/<name>.json holds the reference's results)
GOLDEN = {
    "exhaustive_small": dict(
        base=dict(n_caches=4, costs=(1.0, 2.0, 3.0, 1.5), cache_size=1_500,
                  alg="exhaustive", seed=1),
        values=(100, 800)),
    "fig4_gradle": dict(base=dict(cache_size=2_000, seed=1),
                        values=(64, 512)),
}


def phase_golden(dev, card: str) -> None:
    """Each policy run on its own, so the kernel launches of each are
    read: with the exhaustive subroutine, fna/fno build their tables and
    fna_cal its speculation tables through ``subset_argmin``."""
    from repro_torch.cachesim import SimConfig, get_trace, run_policies
    from repro_torch.kernels.subsetdp import ops
    policies = ("fna", "fna_cal", "fno", "pi")
    trace = get_trace("gradle", 5_000, seed=1)
    for name, spec in GOLDEN.items():
        payload = json.loads(
            (ROOT / "tests" / "golden" / f"{name}.json").read_text())
        check(payload["axis"] == "update_interval" and
              payload["n_requests"] == 5_000, f"{name}: unexpected file")
        got = {v: {} for v in spec["values"]}
        launches = dict.fromkeys(policies, 0)
        for v in spec["values"]:
            cfg = SimConfig(update_interval=v, **spec["base"])
            for p in policies:
                ops.reset_launches()
                got[v].update(run_policies(trace, cfg, (p,), device=dev))
                launches[p] += ops.LAUNCHES["subset_argmin"]
        if spec["base"].get("alg") == "exhaustive":
            check(all(launches[p] > 0 for p in ("fna", "fna_cal", "fno")),
                  f"{name}: a policy built its tables without the kernel")
        print(f"[golden] {name}: subset_argmin launches per policy "
              f"{json.dumps(launches)}")
        seen = 0
        for cell in payload["cells"]:
            res = got[cell["label"]][cell["policy"]]
            check(dataclasses.asdict(res) == cell["result"],
                  f"{name} {cell['label']} {cell['policy']}: card result "
                  f"!= golden")
            seen += 1
        check(seen == len(spec["values"]) * len(policies),
              f"{name}: golden cells missing")
        print(f"[golden] {name}: {seen} cells equal to tests/golden "
              f"bit for bit ({card})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = card_line()
    t_all = time.perf_counter()
    phase_build(card)
    phase_kernel_checks(dev)
    st_b, cfg_b, launches = phase_slice(dev, card)
    record = phase_kernel_times(st_b, cfg_b, launches, card)
    bloom_record = phase_router(dev, st_b, cfg_b, card)
    phase_serve()
    phase_golden(dev, card)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record, bloom_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
