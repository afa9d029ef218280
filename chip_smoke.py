#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits non-zero
(printing no result) without a CUDA device or outside a checkout.
Phases, each failing the run on any mismatch:

  1. build the subset-DP CUDA kernel from ``src/repro_torch/kernels/
     subsetdp/csrc/subsetdp.cu`` (nvcc, sm_90a) and print the card;
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
  4. golden on the card: ``exhaustive_small`` (its fna_cal speculation
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
    from repro_torch.kernels.subsetdp import build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    secs = time.perf_counter() - t0
    print(f"[build] subsetdp.cu -> {build.library_path().name} in "
          f"{secs:.2f} s ({card})")
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


def bound(ops: int, nbytes: int):
    """(least milliseconds, what bounds it) for this much work."""
    t_ops = ops / PEAK_FP64_FLOPS * 1e3
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
    phase_golden(dev, card)
    print(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
