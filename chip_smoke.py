#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits non-zero
(printing no result) without a CUDA device or outside a checkout.
Phases, each failing the run on any mismatch:

  1. build the CUDA kernels, one nvcc per source, all started together
     (``src/repro_torch/kernels/subsetdp/csrc/subsetdp.cu``,
     ``kernels/bloom/csrc/bloom.cu``, ``kernels/flash_attention/csrc/
     flash.cu`` (float32) and ``flash_wgmma.cu`` (bf16), and
     ``kernels/ssd/csrc/ssd.cu``, sm_90a), print the card, and count the
     wgmma (HGMMA) instructions in the bf16 flash library's SASS;
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
     main path's two table builds (fna, and fno with ``allowed``), each
     beside its own bound;
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
     plain version's times at (c1) and (c2), each beside its own bound, and
     (c2)'s sector rates at three spans beside a PyTorch gather of as many
     random bytes; and the ``--replay`` serving entry point once per
     regime;
  5. golden on the card: all 15 ``tests/golden/*.json`` files through the
     port's own scenario layer (``scenario_grid``, the grid step of
     ``run_scenario``: the port's scenarios, its trace-file loader on
     ``tests/data`` for ``trace_file_smoke``, its topology layer for
     ``topo_path``/``topo_tree``), every ``SimResult``/``TopoResult``
     equal to its golden cell field for field; ``exhaustive_small`` runs
     each policy on its own so that each one's kernel launches are read
     (fna/fno tables and fna_cal's speculation tables);
  6. the grid at paper scale: ``run_grid`` over (b)'s configuration on
     the decision-side axis ``miss_penalty`` in (25, 100, 1000), policies
     fno/fna/pi, with an artifact store in a temporary directory of
     ``build/``: one sweep for the three cells, subset-DP launches read
     around it, its 100.0 cell equal to (b)'s results field for field;
     then the same call again on the same store — no sweep, no kernel
     launch (every table from the store), identical results; phase times
     and the store's bytes printed;
  7. ``topo_path`` at paper scale: 1M gradle requests, depths 1, 2 and 3,
     policies pi/fno/fna, per-tier sweeps shared across the depths; its
     depth-1 cell equal to ``run_policies`` of the same tier
     configuration on the card;
  8. the LM serving path: (d1) the flash-attention and SSD kernels against
     their plain versions on the card — flash at the serve shapes
     [1, 24 | 512, 9/3, 64] and a long prefill [1, 2048, 9/3, 64], float32
     (CUDA-core kernel) at 2e-5 and bf16 (wgmma kernel) at 3e-2 and, since
     both keep p in float32 for PV, within one bf16 ulp in at most 1% of
     the outputs; SSD at mamba2-370m's [1, 4096, 32, 64],
     n = 128, chunk 256, and at the padded serve length 300, float32 at
     2e-3 and bf16 at 3e-2; (d2) ``python -m repro_torch.launch.serve``
     (no ``--replay``) at full published width, launch counts read around
     each drive: smollm-135m ``--no-reduced --prefix-len 512 --requests
     200`` (flash launches = 30 x prefills) and mamba2-370m ``--no-reduced
     --prefix-len 300 --requests 100`` (SSD launches = 48 x prefills,
     one per ``ssd_scan`` call, each call five kernels);
     (d3) each model at full width in float32 with seeded weights: prefill
     and greedy decode on the card (kernels) against the CPU (plain
     versions); (d4) the two kernels' times beside their plain versions',
     ``scaled_dot_product_attention``'s (flash) and their bounds.

TF32 is off for matrix products (``torch.backends.cuda.matmul``, the
default) and for cuDNN (``torch.backends.cudnn``, on by default), so that
float32 on the card is float32 as on the CPU; the model path calls no
cuDNN operator (its causal convolution is a shifted sum).

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object describing the kernels of the main path (a kernel launched
more than once on its path also lists each launch's time and bound under
``per_launch``; its ``ms`` and ``bound_ms`` are their sums), and
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

#: H100 SXM peak (NVIDIA data sheet): HBM3
PEAK_BYTES_PER_S = 3.35e12
#: dense bf16 on the tensor cores; float32 outside them
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
#: the paper-scale setup (benchmarks/paper_figs.py _scale(full=True))
PAPER = dict(cache_size=10_000, update_interval=1_000, bpe=14.0,
             est_interval=50, miss_penalty=100.0, seed=0)
N_REQUESTS = 1_000_000
#: the grid phase: (b)'s configuration over the decision-side axis
GRID_PENALTIES = (25.0, 100.0, 1000.0)
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
#: H100 SXM fp64 instructions without an FMA: 132 SMs x 64 fp64 lanes x
#: 1.98 GHz — derived from the SM layout.  The data sheet's 34 TFLOP/s
#: counts an FMA as two flops; the subset-DP's bit-exact contract forbids
#: the FMA (``--fmad=false``, ``__dmul_rn``/``__dadd_rn``), so each multiply
#: and each add is one instruction at this rate
PEAK_FP64_UNFUSED_OPS = 132 * 64 * 1.98e9
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


#: clock cycles the stream waits before a timed burst (~50 ms on an
#: H100): longer than the host takes to enqueue the burst
HOLD_CYCLES = 100_000_000


def device_ms(fn, iters: int) -> float:
    """Milliseconds of device time per call: the mean over ``iters`` calls
    after one warm-up, between CUDA events around the calls, enqueued while
    the stream waits on a spin kernel, so that the card runs them back to
    back.  Unlike events around calls that run as they are enqueued, it
    excludes the idle gaps left when the host enqueues more slowly than the
    card runs (a call of a few microseconds on the card, at the serve
    shapes); it keeps the card's own gaps between the kernels of a call.
    Every kernel time the script records is this one."""
    import torch
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def kernel_shares(fn, iters: int) -> dict:
    """{kernel key: device ms per record} of ``iters`` calls from a
    ``torch.profiler`` trace, for the log only: a trace can miss records,
    so each kernel's time is its mean over the records it caught."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    return {e.key: e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def phase_build(card: str) -> float:
    """Every kernel source built at once (one nvcc each), then loaded; the
    bf16 flash library's SASS shows its wgmma (HGMMA) instructions."""
    from repro_torch.kernels.bloom import build as bloom_build
    from repro_torch.kernels.flash_attention import build as flash_build
    from repro_torch.kernels.ssd import build as ssd_build
    from repro_torch.kernels.subsetdp import build as subsetdp_build
    libs = (subsetdp_build.KERNEL, bloom_build.KERNEL, *flash_build.KERNELS,
            ssd_build.KERNEL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.build(verbose=True), libs))
    for k in libs:
        k.load()
    secs = time.perf_counter() - t0
    names = ", ".join(f"{k.source.name} -> {k.library_path().name}"
                      for k in libs)
    print(f"[build] {names} in {secs:.2f} s ({card})")
    sass = subprocess.run(
        [str(Path(flash_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(flash_build.KERNEL_BF16.library_path())],
        capture_output=True, text=True, timeout=120, check=True).stdout
    hgmma = [ln.split()[1] for ln in sass.splitlines() if "HGMMA." in ln]
    kinds = {op: hgmma.count(op) for op in sorted(set(hgmma))}
    print(f"[build] flash_wgmma.cu SASS: {len(hgmma)} HGMMA instructions "
          f"{json.dumps(kinds)}")
    check(any(k.startswith("HGMMA.64x64x16") for k in kinds),
          "flash_wgmma.cu: no 64x64x16 wgmma in its SASS")
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
    """Phase 3: both paper-scale configurations; returns (b)'s sweep,
    configuration, results and main-path kernel launches."""
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
    return st_b, cfg_b, res_b, launches


def _popcount(x, n: int):
    import torch
    return ((x[:, None] >> torch.arange(n, device=x.device)) & 1).sum(1)


def argmin_work(rhos, mp, allowed):
    """(fp64 operations, bytes) that ``subset_argmin`` needs on these
    inputs: one multiply per non-empty allowed mask (a subset's product is
    its prefix's times one rho) and one add per allowed mask — only the
    subsets of ``allowed[b]`` where it is given; every input read once
    (rhos, the 2^n cost vector, M — one value or one a row —, allowed) and
    the [B] output written once.  The compare is not counted: every value
    is >= 0, so it can run on the integer pipe beside the fp64 one."""
    b, n = rhos.shape
    k = 1 << n
    masks = b * k if allowed is None else \
        int((1 << _popcount(allowed, n)).sum())
    ops = 2 * masks - b
    nbytes = rhos.numel() * 8 + k * 8 + mp.numel() * 8 + b * 8 + \
        (0 if allowed is None else b * 8)
    return ops, nbytes


def prod_work(rhos):
    """(operations, bytes) for ``subset_prod``: one multiply per non-empty
    mask; rhos and M read once, the [B, 2^n] output written once."""
    b, n = rhos.shape
    k = 1 << n
    return b * (k - 1), rhos.numel() * 8 + 8 + b * k * 8


def bound(ops: int, nbytes: int, peak_ops: float):
    """(least milliseconds, what bounds it) for this much work at
    ``peak_ops`` operations per second."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _times_line(name: str, ms: float, plain_ms: float, bound_ms: float,
                by: str, detail: str, card: str) -> None:
    print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}; {detail}), {bound_ms / ms:.1%} of "
          f"the bound reached ({card})")


def _summed(name: str, launches: list, card: str) -> dict:
    """The record's times and bound over a path's launches: the sum of each
    launch's own time and of each launch's own bound; ``bound_by`` is the
    larger bound's, ``per_launch`` keeps each one."""
    total = {key: sum(x[key] for x in launches)
             for key in ("ms", "plain_ms", "bound_ms")}
    total["bound_by"] = max(launches, key=lambda x: x["bound_ms"])["bound_by"]
    _times_line(name, total["ms"], total["plain_ms"], total["bound_ms"],
                total["bound_by"], "the sum of the launches' own bounds",
                card)
    total["per_launch"] = launches
    return total


def phase_kernel_times(st, cfg, launches, card: str):
    """The kernel against its plain version on the main path's inputs, the
    rows of each launch the paths make, as they lay them out
    (``core.batched._exhaustive_rows``): slice (b)'s two launches — the fna
    table's [V * 256, 8] rho rows by version, the fno table's by pattern
    with CS_FNO ``allowed`` = each row's pattern, M the device tensor the
    path passes — and the grid's two, the same rows once per miss penalty
    with one penalty a row (``exhaustive_tables_cells``).  Each launch is
    timed beside its own bound; the record holds their sums.  ``launches``
    maps each path that drives the kernel to its count; the record's
    ``launches`` is their sum."""
    import torch
    from repro_torch.core.batched import _exhaustive_rows
    from repro_torch.kernels.subsetdp import ops, ref
    d = st.device_arrays()
    costs = list(cfg.costs)
    before = dict(ops.LAUNCHES)
    per_launch, err = [], 0
    v, n = d["pi"].shape
    dev = d["pi"].device
    cost = ops.subset_costs(costs, n, dev)
    for path, pens in (("slice_b", (cfg.miss_penalty,)),
                       ("grid", GRID_PENALTIES)):
        mp = torch.as_tensor(pens, dtype=torch.float64, device=dev)
        if len(pens) > 1:
            mp = mp.repeat_interleave(v << n)
        for policy in ("fna", "fno"):
            rhos, allowed = _exhaustive_rows(d["pi"], d["nu"],
                                             policy == "fno", len(pens))
            b = rhos.shape[0]
            kern = ops.subset_argmin(costs, rhos, mp, allowed=allowed)
            plain = ref.subset_argmin_ref(cost, rhos, mp, allowed)
            e = int((kern - plain).abs().max())
            err = max(err, e)
            check(e == 0, f"subset_argmin != plain on {path}'s {policy} "
                          f"table")
            ms = device_ms(lambda: ops.subset_argmin(costs, rhos, mp,
                                                   allowed=allowed), 20)
            plain_ms = device_ms(lambda: ref.subset_argmin_ref(
                cost, rhos, mp, allowed), 2)
            n_ops, nbytes = argmin_work(rhos, mp, allowed)
            bound_ms, by = bound(n_ops, nbytes, PEAK_FP64_UNFUSED_OPS)
            _times_line(f"subset_argmin {path} {policy} table B={b} n={n}",
                        ms, plain_ms, bound_ms, by, f"{n_ops} fp64 "
                        f"operations, {nbytes} bytes", card)
            per_launch.append({"launch": f"{path} {policy}", "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": by})
    total = _summed("subset_argmin, the main path's launches", per_launch,
                    card)
    mp = torch.as_tensor([cfg.miss_penalty], dtype=torch.float64, device=dev)
    # subset_prod (validation counterpart, off the main path) at a slice
    # of the fna rows: its [rows, 2^n] output is what the fused kernel
    # keeps out of device memory
    sub = _exhaustive_rows(d["pi"], d["nu"], False)[0][: 1 << 18]
    prod_ms = device_ms(lambda: ops.subset_prod(sub, mp), 10)
    prod_plain_ms = device_ms(lambda: ref.subset_prod_ref(sub, mp), 2)
    p_ops, p_bytes = prod_work(sub)
    p_bound, p_by = bound(p_ops, p_bytes, PEAK_FP64_UNFUSED_OPS)
    _times_line(f"subset_prod B={sub.shape[0]} n={n}", prod_ms,
                prod_plain_ms, p_bound, p_by, f"{p_ops} fp64 operations, "
                f"{p_bytes} bytes", card)
    check(dict(ops.LAUNCHES) != before, "timing runs launched no kernel")
    return {
        "name": "subsetdp.subset_argmin", "route": "cuda",
        "source": "src/repro_torch/kernels/subsetdp/csrc/subsetdp.cu",
        "replaces": "src/repro/kernels/subsetdp/subsetdp.py:41",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": err, "library_ms": None, **total,
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

    # times at (c1) and (c2), each beside the bound of its own inputs
    limit = bloom.ops.stage_limit(dev)
    per_launch = []
    for tag, bits, keys in cases:
        ms = device_ms(lambda: bloom.bloom_probe(bits, keys, k=k), 20)
        plain_ms = device_ms(lambda: ref.bloom_probe_ref(bits, keys, k), 2)
        n_ops, nbytes = bloom_work(bits, keys, k)
        bound_ms, by = bound(n_ops, nbytes, PEAK_INT32_OPS)
        where = "shared memory" if bits.numel() <= limit else "device memory"
        _times_line(f"bloom_probe {tag} B={keys.shape[0]} n={bits.shape[0]} "
                    f"m_bytes={bits.shape[1]} (bitmaps in {where})", ms,
                    plain_ms, bound_ms, by, f"{n_ops} int32 operations, "
                    f"{nbytes} bytes", card)
        per_launch.append({"launch": tag, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": by})
    total = _summed("bloom_probe, the three launches", per_launch, card)
    _fleet_sector_rates(stale, keys2, k, card)
    return {
        "name": "bloom.bloom_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/bloom/csrc/bloom.cu",
        "replaces": "src/repro/kernels/bloom/bloom.py:30",
        "launches": launches["bloom_probe"], "max_abs_err": err,
        "library_ms": None, **total,
    }


def _fleet_sector_rates(stale, keys, k: int, card: str) -> None:
    """What bounds (c2): the kernel's sector rates on the first 4, 8 and
    16 stale bitmaps (spans of 280 MB, 560 MB and 1.12 GB, all beyond the
    L2), beside the card's random-byte rate over the same spans — one
    PyTorch gather (``flat[idx]``) of as many uniformly random bytes as the
    kernel's needed probes, every load independent.  ``distinct`` counts
    each needed 32-byte sector once (``bloom_work``'s bytes); ``probe``
    counts one sector per needed probe (what the kernel loads when no
    sector stays in L2 between two keys)."""
    import torch
    from repro_torch.kernels import bloom
    g = torch.Generator(stale.device).manual_seed(0)
    for n in (4, 8, 16):
        bits = stale[:n]
        probes, sectors = _probe_needs(bits, keys, k)
        ms = device_ms(lambda: bloom.bloom_probe(bits, keys, k=k), 10)
        flat = bits.reshape(-1)
        idx = torch.randint(0, flat.numel(), (probes,), device=stale.device,
                            generator=g)
        gather_ms = device_ms(lambda: flat[idx], 10)
        print(f"[times] bloom_probe (c2) first {n} stale bitmaps "
              f"({bits.numel()} bytes): kernel {ms:.4f} ms, {probes} needed "
              f"probes, {sectors} distinct sectors: distinct "
              f"{sectors * 32 / ms / 1e9:.3f} TB/s, probe "
              f"{probes * 32 / ms / 1e9:.3f} TB/s; gather of {probes} random "
              f"bytes over the same span {gather_ms:.4f} ms, "
              f"{probes * 32 / gather_ms / 1e9:.3f} TB/s of sectors ({card})")


def phase_serve() -> None:
    """The serving entry point (host-only router replay) once per regime."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serving import REGIMES
    for regime in sorted(REGIMES):
        rc = serve_main(["--replay", "--mode", "sequential", "--regime",
                         regime, "--requests", "4000"])
        check(rc == 0, f"serve --replay {regime} exited {rc}")


def _golden_fields(res) -> dict:
    """Every field of a result dataclass as a golden file holds it."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def phase_golden(dev, card: str) -> dict:
    """Phase 5: all 15 golden files through the port's scenario layer on
    the card; returns ``exhaustive_small``'s subset-DP launches per
    policy."""
    from repro_torch.cachesim import (GOLDEN_SCENARIOS, get_scenario,
                                      scenario_grid)
    from repro_torch.cachesim.scenarios import scenario_records
    from repro_torch.cachesim.sweep import hashable_label
    from repro_torch.kernels.subsetdp import ops
    t_all = time.perf_counter()
    launches = {}
    for name in GOLDEN_SCENARIOS:
        sc = get_scenario(name)
        payload = json.loads(
            (ROOT / "tests" / "golden" / f"{name}.json").read_text())
        check(payload["axis"] == sc.axis and
              payload["n_requests"] == sc.golden_n_requests,
              f"{name}: unexpected golden file")
        t0 = time.perf_counter()
        if name == "exhaustive_small":
            grid = {}
            for p in sc.policies:
                ops.reset_launches()
                part, values = scenario_grid(sc, golden=True, policies=(p,),
                                             device=dev)
                launches[p] = ops.LAUNCHES["subset_argmin"]
                for key, cell in part.items():
                    grid.setdefault(key, {}).update(cell)
            check(all(launches[p] > 0 for p in ("fna", "fna_cal", "fno")),
                  f"{name}: a policy built its tables without the kernel")
            print(f"[golden] {name}: subset_argmin launches per policy "
                  f"{json.dumps(launches)}")
        else:
            grid, values = scenario_grid(sc, golden=True, device=dev)
        sync()
        secs = time.perf_counter() - t0
        records = scenario_records(sc, grid, values)
        cells = payload["cells"]
        check(len(cells) == len(records) == len(grid) * len(sc.policies),
              f"{name}: golden cells missing")
        for cell in cells:
            key = (cell["trace"], hashable_label(cell["label"]))
            res = grid[key][cell["policy"]]
            check(_golden_fields(res) == cell["result"],
                  f"{name} {key} {cell['policy']}: card result != golden")
        print(f"[golden] {name}: {len(cells)} {type(res).__name__} cells "
              f"equal to tests/golden bit for bit, {secs:.3f} s ({card})")
    print(f"[golden] all {len(GOLDEN_SCENARIOS)} golden files equal on the "
          f"card in {time.perf_counter() - t_all:.3f} s ({card})")
    return launches


def _store_bytes(store) -> dict:
    out = {}
    for _, kind, size, _ in store.entries():
        out[kind] = out.get(kind, 0) + size
    return out


def phase_grid(dev, cfg_b, res_b, card: str) -> dict:
    """Phase 6: ``run_grid`` at paper scale, cold then warm on one store;
    returns the subset-DP launches of each run."""
    import tempfile
    import repro_torch.cachesim.systemstate as systemstate
    from repro_torch.cachesim import ArtifactStore, RunReport, get_trace, \
        run_grid
    from repro_torch.kernels.subsetdp import ops
    trace = get_trace("gradle", N_REQUESTS, seed=0)
    pol = ("fno", "fna", "pi")
    (ROOT / "build").mkdir(exist_ok=True)
    launches, runs = {}, {}
    with tempfile.TemporaryDirectory(prefix="grid-store-",
                                     dir=ROOT / "build") as root:
        for tag in ("cold", "warm"):
            store = ArtifactStore(root)
            report = RunReport()
            before = systemstate.SWEEPS_COMPUTED
            ops.reset_launches()
            t0 = time.perf_counter()
            grid = run_grid({"gradle": trace}, cfg_b, "miss_penalty",
                            GRID_PENALTIES, policies=pol, store=store,
                            device=dev, report=report)
            sync()
            secs = time.perf_counter() - t0
            launches[tag] = ops.LAUNCHES["subset_argmin"]
            runs[tag] = (grid, systemstate.SWEEPS_COMPUTED - before)
            print(f"[grid] {tag}: run_grid n=8 exhaustive, miss_penalty "
                  f"{GRID_PENALTIES}, policies {pol}, {N_REQUESTS} gradle "
                  f"requests: {secs:.3f} s; {runs[tag][1]} sweeps computed; "
                  f"subset_argmin launches {launches[tag]}; store "
                  f"{json.dumps(store.stats)}, bytes "
                  f"{json.dumps(_store_bytes(store))}; {_phases(report)} "
                  f"({card})")
    (cold, n_cold), (warm, n_warm) = runs["cold"], runs["warm"]
    check(n_cold == 1, f"the cold grid computed {n_cold} sweeps, not 1")
    check(launches["cold"] > 0, "the grid launched no subset_argmin kernel")
    check(n_warm == 0 and launches["warm"] == 0,
          f"the warm grid computed {n_warm} sweeps and made "
          f"{launches['warm']} kernel launches")
    for p in pol:
        got = cold[("gradle", 100.0)][p]
        check(dataclasses.asdict(got) == dataclasses.asdict(res_b[p]) and
              got.to_dict() == res_b[p].to_dict(),
              f"grid cell 100.0 {p} != slice (b)'s result")
    for key, cell in cold.items():
        for p, res in cell.items():
            check(dataclasses.asdict(res) ==
                  dataclasses.asdict(warm[key][p]) and
                  (res.advert_events, res.advert_bytes) ==
                  (warm[key][p].advert_events, warm[key][p].advert_bytes),
                  f"warm grid {key} {p} != cold")
        print(f"[grid] {key}: " + ", ".join(
            f"{p} mean_cost {res.mean_cost!r}" for p, res in cell.items()))
    print(f"[grid] one sweep for {len(GRID_PENALTIES)} cells; the 100.0 "
          f"cell equals slice (b) field for field; the warm run computed no "
          f"sweep, launched no kernel and returned identical results")
    return launches


def phase_topology(dev, card: str) -> None:
    """Phase 7: ``topo_path`` at 1M requests, depths 1-3; its depth-1 cell
    against the flat engine on the same tier configuration."""
    import repro_torch.cachesim.systemstate as systemstate
    from repro_torch.cachesim import (SimResult, get_scenario, run_policies,
                                      scenario_grid)
    from repro_torch.cachesim.scenarios import scenario_records
    from repro_torch.cachesim.topology import topo_cell
    sc = get_scenario("topo_path")
    pol = ("pi", "fno", "fna")
    before = systemstate.SWEEPS_COMPUTED
    t0 = time.perf_counter()
    grid, values = scenario_grid(sc, n_requests=N_REQUESTS, policies=pol,
                                 device=dev)
    sync()
    secs = time.perf_counter() - t0
    records = scenario_records(sc, grid, values)
    check(len(records) == len(values) * len(pol), "topo_path records")
    print(f"[topo] topo_path, {N_REQUESTS} gradle requests, depths {values}, "
          f"policies {pol}: {secs:.3f} s, "
          f"{systemstate.SWEEPS_COMPUTED - before} tier sweeps ({card})")
    for d in values:
        cell = grid[("gradle", d)]
        first = cell[pol[0]]
        print(f"[topo] depth {d}: tier arrivals {first.tier_arrivals}, tier "
              f"rejected {first.tier_rejected}; " + ", ".join(
                  f"{p} mean_cost {r.mean_cost!r} mean_latency "
                  f"{r.mean_latency!r} tier hits {r.tier_hits}"
                  for p, r in cell.items()))
    trace = sc.make_traces(N_REQUESTS)["gradle"]
    cfg = topo_cell(sc.config(), {"depth": 1}).node_config(0, 0)
    t0 = time.perf_counter()
    flat = run_policies(trace, cfg, pol, device=dev)
    flat_s = time.perf_counter() - t0
    for p in pol:
        got = grid[("gradle", 1)][p]
        for f in dataclasses.fields(SimResult):
            check(getattr(got, f.name) == getattr(flat[p], f.name),
                  f"topo_path depth 1 {p} {f.name} != flat run_policies")
        check((got.advert_events, got.advert_bytes) ==
              (flat[p].advert_events, flat[p].advert_bytes),
              f"topo_path depth 1 {p}: advert totals != flat")
    print(f"[topo] depth-1 cell == flat run_policies on the same tier "
          f"configuration for {pol} (flat run {flat_s:.3f} s) ({card})")


# ---------------------------------------------------------------------------
# the LM serving path (flash attention and the SSD scan)
# ---------------------------------------------------------------------------

#: flash kernel checks: (name, B, S, Hq, Hkv, D) — the serve shapes of
#: smollm-135m (prefix 24, the launcher's default, and 512) and a long
#: prefill; causal (the prefill) and non-causal
FLASH_SHAPES = (("serve24", 1, 24, 9, 3, 64), ("serve512", 1, 512, 9, 3, 64),
                ("long2048", 1, 2048, 9, 3, 64))
#: SSD checks: (name, b, s, h, p, n, chunk) — mamba2-370m's widths at the
#: padded serve length and at a 4096-token prefill
SSD_SHAPES = (("serve300", 1, 300, 32, 64, 128, 256),
              ("long4096", 1, 4096, 32, 64, 128, 256))
#: (dtype name, tolerance): float32 at the JAX kernel tests' gates (2e-5
#: flash, 2e-3 SSD: summation order only); bf16 at 3e-2 (o, resp. y,
#: rounded to bf16 from float32 values that differ in summation order)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: bf16 flash: p stays float32 for PV on both sides (the kernel splits it
#: in two bf16 parts), so kernel and plain version round o to bf16 from
#: float32 values that differ in summation order and by p's low 8 bits:
#: one bf16 ulp apart (at least 2^-9) in at most this share of outputs.
#: Rounding p to bf16 once makes about a third of them differ.
FLASH_BF16_SHARE = 0.01
SSD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
#: the full-width serve drives: (arch, launcher flags, kernel)
SERVE_DRIVES = (("smollm-135m", ["--prefix-len", "512", "--requests", "200"],
                 "flash_attention"),
                ("mamba2-370m", ["--prefix-len", "300", "--requests", "100"],
                 "ssd_scan"))
#: full-width float32 card vs CPU: prompt length and decode steps per
#: model; logits within LOGIT_TOL (rtol and atol): float32 on both sides,
#: cuBLAS and the CPU's BLAS sum in other orders across 30 or 48 layers
LM_COMPARE = {"smollm-135m": 512, "mamba2-370m": 300}
LM_DECODE_STEPS = 8
LOGIT_TOL = 2e-3


def _err(got, want, tol: float):
    """(max |got - want|, whether every element is within tol + tol|want|)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def _bf16_ulp_close(got, want):
    """(share of outputs that differ, whether every output is within one
    bf16 ulp of ``want``, at least 2^-9)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    ulp[w == 0] = 0.0
    return (float((diff > 0).float().mean()),
            bool((diff <= torch.clamp(ulp, min=2.0 ** -9)).all()))


def _flash_inputs(b, s, hq, hkv, d, dtype, dev, seed):
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _ssd_inputs(b, s, h, p, n, dtype, dev, seed):
    """x, B, C standard normal; dt = softplus(N(0,1) - 1) and A = -exp(U)
    as the JAX kernel tests draw them; dt and A float32."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev) - 1.0)
    A = -torch.exp(torch.rand(h, generator=g, device=dev) * 2.0 - 1.0)
    B = torch.randn((b, s, n), generator=g, device=dev).to(dtype)
    C = torch.randn((b, s, n), generator=g, device=dev).to(dtype)
    return x, dt, A, B, C


def phase_lm_kernel_checks(dev) -> dict:
    """(d1) Each LM kernel against its plain version on the card
    (comparison launches; they do not count towards the main path).
    Returns the largest error per kernel at the main path's type."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    errs = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for name, b, s, hq, hkv, d in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_TOL[str(dtype)[6:]]
            q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, dev, s)
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                sync()
                want = fa.flash_attention_ref(q, k, v, causal=causal)
                err, ok = _err(got, want, tol)
                check(ok, f"flash {name} {dtype} causal={causal}: kernel != "
                          f"plain (max |err| {err})")
                extra = ""
                if dtype == torch.bfloat16:
                    share, in_ulp = _bf16_ulp_close(got, want)
                    check(in_ulp and share <= FLASH_BF16_SHARE,
                          f"flash {name} bf16 causal={causal}: {share:.2%} "
                          f"of outputs differ from plain, within one ulp: "
                          f"{in_ulp}")
                    extra = (f"; {share:.3%} of outputs differ, all within "
                             f"one bf16 ulp (limit {FLASH_BF16_SHARE:.0%})")
                    if causal and name == "serve512":
                        errs["flash_attention"] = err
                print(f"[lm kernel] flash {name} {str(dtype)[6:]} causal="
                      f"{causal}: max |kernel - plain| {err!r} (tol {tol})"
                      f"{extra}")
    for name, b, s, h, p, n, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tol = SSD_TOL[str(dtype)[6:]]
            x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, dtype, dev, s)
            st0 = torch.randn((b, h, p, n), device=dev,
                              generator=torch.Generator(dev).manual_seed(1))
            for init in (None, st0):
                y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                     initial_state=init)
                sync()
                y_r, st_r = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                             initial_state=init)
                err, ok = _err(y, y_r, tol)
                serr, sok = _err(st, st_r, SSD_TOL["float32"])
                check(ok and sok, f"ssd {name} {dtype}: kernel != plain "
                                  f"(y {err}, state {serr})")
                if dtype == torch.bfloat16 and init is None and \
                        name == "serve300":
                    errs["ssd_scan"] = err
                print(f"[lm kernel] ssd {name} {str(dtype)[6:]} initial_"
                      f"state={init is not None}: max |kernel - plain| y "
                      f"{err!r}, state {serr!r} (tol {tol})")
    return errs


def _serve_line(text: str) -> dict:
    import re
    last = [ln for ln in text.splitlines() if "policy=" in ln][-1]
    out = {k: float(re.search(rf"\b{k}=([0-9.,]+)", last).group(1)
                    .replace(",", ""))
           for k in ("requests", "hit", "prefills", "tok/s", "wall")}
    out["prefill_s"] = float(re.search(r"\(prefill ([0-9.]+)s\)",
                                       last).group(1))
    return out


def phase_lm_serve(card: str) -> dict:
    """(d2) The serving launcher at full width on the card, each drive's
    kernel launches read around it; returns launches per kernel."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.serve import main as serve_main
    launches = {}
    for arch, flags, kernel in SERVE_DRIVES:
        argv = ["--arch", arch, "--no-reduced", "--device", "cuda"] + flags
        fa.reset_launches()
        ssd.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_main(argv)
        secs = time.perf_counter() - t0
        counts = {**fa.LAUNCHES, **ssd.LAUNCHES}
        print(buf.getvalue(), end="")
        check(rc == 0, f"serve {arch} exited {rc}")
        stats = _serve_line(buf.getvalue())
        n_layers = get_config(arch).n_layers
        want = n_layers * int(stats["prefills"])
        print(f"[lm serve] {arch} full width: {json.dumps(counts)} kernel "
              f"launches for {int(stats['prefills'])} prefills x "
              f"{n_layers} layers; {secs:.3f} s in all ({card})")
        check(stats["prefills"] > 0 and counts[kernel] == want,
              f"{arch}: {counts[kernel]} {kernel} launches, expected {want}")
        check(sum(counts.values()) == want,
              f"{arch}: launched a kernel of the other model family")
        launches[kernel] = counts[kernel]
    return launches


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def _lm_compare(arch: str, dev, card: str) -> None:
    """(d3) Full width, float32, seeded weights: prefill logits and the
    cache, then greedy decode on the CPU and the card fed the CPU's
    tokens; the card's greedy choice must match the CPU's wherever the
    CPU's top-2 gap exceeds the logit tolerance."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    cfg = dc.replace(get_config(arch), dtype="float32")
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    params_card = _to_device(params, dev)
    s = LM_COMPARE[arch]
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s)))
    kw = {} if cfg.family == "ssm" else {"max_len": s + LM_DECODE_STEPS}
    with torch.no_grad():
        t0 = time.perf_counter()
        lg_c, cache_c = model.prefill(params, {"tokens": toks}, **kw)
        cpu_s = time.perf_counter() - t0
        lg_g, cache_g = model.prefill(params_card, {"tokens": toks.to(dev)},
                                      **kw)
        sync()
        worst, ok = _err(lg_g.cpu(), lg_c, LOGIT_TOL)
        for name, val in cache_c.items():
            if isinstance(val, torch.Tensor):
                e, o = _err(cache_g[name].cpu(), val, LOGIT_TOL)
                check(o, f"{arch} float32 prefill cache {name}: card != CPU "
                         f"(max |err| {e})")
        check(ok, f"{arch} float32 prefill logits: card != CPU ({worst})")
        flips = 0
        tok = lg_c[:, :cfg.vocab].argmax(-1)
        for _ in range(LM_DECODE_STEPS):
            lg_c, cache_c = model.decode_step(params, cache_c, tok)
            lg_g, cache_g = model.decode_step(params_card, cache_g,
                                              tok.to(dev))
            e, o = _err(lg_g.cpu(), lg_c, LOGIT_TOL)
            check(o, f"{arch} float32 decode logits: card != CPU ({e})")
            worst = max(worst, e)
            nxt = lg_c[:, :cfg.vocab].argmax(-1)
            top2 = lg_c[0, :cfg.vocab].topk(2).values
            if int(lg_g[:, :cfg.vocab].argmax(-1).cpu()) != int(nxt):
                flips += 1
                check(float(top2[0] - top2[1]) <= 2 * LOGIT_TOL,
                      f"{arch}: greedy token differs outside a near-tie")
            tok = nxt
    print(f"[lm compare] {arch} full width float32, prompt {s}: prefill + "
          f"{LM_DECODE_STEPS} greedy decode steps, max |card - CPU| logit "
          f"{worst!r} (tol {LOGIT_TOL}), greedy tokens equal in "
          f"{LM_DECODE_STEPS - flips} of {LM_DECODE_STEPS} steps (near-tie "
          f"flips allowed); CPU prefill {cpu_s:.3f} s ({card})")


def flash_work(b, sq, sk, hq, hkv, d, causal: bool, elem: int):
    """(flops, bytes) the attention needs: 2 flops per multiply-add of
    QK^T and of PV over the (query, key) pairs the mask keeps; q, k, v
    read once and o written once."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4 * b * hq * d * pairs, elem * (2 * b * sq * hq * d +
                                           2 * b * sk * hkv * d)


def ssd_work(b, s, h, p, n, chunk: int, elem: int):
    """(tensor-core flops, CUDA-core flops, bytes) the chunked scan needs
    on these rows: per chunk of l real rows, C.B^T over the l(l+1)/2 kept
    pairs once per sequence (the heads share B and C; the bf16 kernel runs
    it on the tensor cores), and per head the weighted sum over those
    pairs (p wide), the inter-chunk product and the state update (l*p*n
    each), 2 flops per multiply-add; the exps, the cumsum and the scalings
    are lower-order and not counted.  Bytes: x, B, C, dt, A read once, y
    and the final state written once."""
    cb = rest = 0
    for c0 in range(0, s, chunk):
        l_ = min(chunk, s - c0)
        pairs = l_ * (l_ + 1) // 2
        cb += b * 2 * n * pairs
        rest += b * h * (2 * p * pairs + 4 * l_ * p * n)
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (
        b * s * h + h + b * h * p * n)
    return cb, rest, nbytes


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name, without namespace and signature."""
    import re
    found = re.search(r"(\w+_kernel)\b", key)
    return found.group(1) if found else key[:40]


def phase_lm_times(dev, launches: dict, errs: dict, card: str):
    """(d4) Kernel, plain version and (flash) SDPA times at the main
    path's shapes (bf16: flash [1, 512, 9/3, 64] causal, SSD [1, 300, 32,
    64] chunk 256) and at the long shapes; returns the two records.  The
    times are device times (``device_ms``).  The flash kernel and SDPA are
    timed in turns (SDPA, kernel, kernel, SDPA), the better of two each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    bf = torch.bfloat16
    records = []
    for name, b, s, hq, hkv, d in FLASH_SHAPES[1:]:
        q, k, v = _flash_inputs(b, s, hq, hkv, d, bf, dev, s)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        plain = lambda: fa.flash_attention_ref(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        # in turns: SDPA, kernel, kernel, SDPA
        lib1, ms1, ms2, lib2 = (device_ms(f, 50) for f in (sdpa, kern, kern,
                                                           sdpa))
        ms, lib_ms = min(ms1, ms2), min(lib1, lib2)
        plain_ms = device_ms(plain, 5)
        flops, nbytes = flash_work(b, s, s, hq, hkv, d, True, 2)
        bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"[times] flash_attention {name} bf16 causal [{b}, {s}, {hq}/"
              f"{hkv}, {d}]: device time kernel {ms:.4f} ms ({ms1:.4f}, "
              f"{ms2:.4f}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
              f"({lib1:.4f}, {lib2:.4f}); bound {bound_ms:.6f} ms ({by}; "
              f"{flops} flops, {nbytes} bytes) ({card})")
        if name == "serve512":
            records.append({
                "name": "flash_attention.flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_wgmma.cu",
                "replaces": "src/repro/kernels/flash_attention/flash.py:32",
                "launches": launches["flash_attention"],
                "max_abs_err": errs["flash_attention"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": lib_ms})
    for name, b, s, h, p, n, chunk in SSD_SHAPES:
        x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, bf, dev, s)
        kern = lambda: ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)  # noqa: E731
        ms = device_ms(kern, 20)
        stages = kernel_shares(kern, 20)
        plain_ms = device_ms(lambda: ssd.ssd_scan_ref(x, dt, A, B, C,
                                                      chunk=chunk), 3)
        tc_flops, flops, nbytes = ssd_work(b, s, h, p, n, chunk, 2)
        # C.B^T at the bf16 tensor-core peak, the rest at the float32 one:
        # in float32-peak-equivalent operations
        eq = flops + tc_flops * PEAK_FP32_FLOPS / PEAK_BF16_FLOPS
        bound_ms, by = bound(eq, nbytes, PEAK_FP32_FLOPS)
        print(f"[times] ssd_scan {name} bf16 [{b}, {s}, {h}, {p}] n={n} "
              f"chunk={chunk}: device time kernel {ms:.4f} ms (five "
              f"kernels), plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({by}; "
              f"{tc_flops} bf16 tensor-core flops, {flops} float32 flops, "
              f"{nbytes} bytes) ({card})")
        print(f"[times] ssd_scan {name} stages (device ms a launch, "
              f"profiler trace): " +
              ", ".join(f"{_kernel_name(k)} {v:.4f}"
                        for k, v in stages.items()))
        if name == "serve300":
            records.append({
                "name": "ssd.ssd_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
                "replaces": "src/repro/kernels/ssd/ssd.py:28",
                "launches": launches["ssd_scan"],
                "max_abs_err": errs["ssd_scan"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                "library_ms": None})
    return records


def phase_lm(dev, card: str):
    """Phase 8: the LM serving path; returns the two kernel records."""
    errs = phase_lm_kernel_checks(dev)
    launches = phase_lm_serve(card)
    for arch in LM_COMPARE:
        _lm_compare(arch, dev, card)
    return phase_lm_times(dev, launches, errs, card)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = card_line()
    t_all = time.perf_counter()
    phase_build(card)
    phase_kernel_checks(dev)
    st_b, cfg_b, res_b, launches = phase_slice(dev, card)
    bloom_record = phase_router(dev, st_b, cfg_b, card)
    phase_serve()
    phase_golden(dev, card)
    grid_launches = phase_grid(dev, cfg_b, res_b, card)
    phase_topology(dev, card)
    record = phase_kernel_times(
        st_b, cfg_b, {"slice_b": launches["subset_argmin"],
                      "grid_cold": grid_launches["cold"],
                      "grid_warm": grid_launches["warm"]}, card)
    lm_records = phase_lm(dev, card)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record, bloom_record, *lm_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
