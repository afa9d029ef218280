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
     [1, 24 | 512, 9/3, 64], a long prefill [1, 2048, 9/3, 64],
     zamba2-7b's shared attention [1, 512, 32/32, 112] (head dim 112),
     zamba2-7b-instruct's [1, 4090, 32/32, 224] at its softmax scale
     (224/2)^-1/2 and a seamless-m4t-medium cross attention [1, 256 q,
     16/16, 64] against 384 keys, each causal (the top-left mask where
     Sq != Sk) and not, float32 (CUDA-core kernel) at 2e-5 and bf16
     (wgmma kernel) at 3e-2
     and, since both keep p in float32 for PV, within one bf16 ulp in at
     most 1% of the outputs; SSD at mamba2-370m's [1, 4096, 32, 64],
     n = 128, chunk 256, at its padded serve length 300, and at
     zamba2-7b's [1, 512, 112, 64], n = 64, chunk 256, and at
     zamba2-7b-instruct's [1, 4090, 112, 64], n = 64, chunk 256, with B
     and C in 2 groups, float32 at 2e-3 and bf16 at 3e-2; (d2) ``python
     -m repro_torch.launch.serve`` (no ``--replay``) at each published
     config (``--no-reduced``, uncut),
     launch counts read around each drive and checked exactly per
     prefill: smollm-135m ``--prefix-len 512`` (flash 30 a prefill),
     mamba2-370m ``--prefix-len 300`` (SSD 48, one per ``ssd_scan`` call,
     each call five kernels), granite-moe-3b-a800m ``--prefix-len 512``
     (flash 32), internvl2-1b ``--prefix-len 64`` after its 1,024 patches
     (flash 24), seamless-m4t-medium ``--prefix-len 256`` (flash 36: 12
     encoder, 12 decoder self, 12 cross), zamba2-7b ``--prefix-len
     512`` (flash 13, one per shared application, SSD 81) and
     zamba2-7b-instruct ``--prefix-len 4090`` (flash 13, SSD 81), every
     SSD call on the tensor cores (``ssd.MMA_LAUNCHES`` equal to the SSD
     launches: bf16 compute), each with its prefill seconds, decode tokens per second (the tokens the launcher
     reports decoded), weight-draw seconds and peak device memory; (d3)
     each model at its published widths in float32 with seeded weights:
     prefill and greedy decode on the card (kernels) against the CPU
     (plain versions), logits and caches at every step — at full depth
     except zamba2-7b (12 of 81 Mamba blocks: 2 shared applications, both
     shared blocks) and granite-moe-3b-a800m (8 of 32 layers), cut to
     spare the CPU's float32 time and the host's memory; granite's card
     routings are held to the CPU's (the same experts for every token
     outside a 1e-5 relative near-tie, and the CPU's experts inside it);
     (d4) the two kernels' times at every main-path shape beside their
     plain versions', ``scaled_dot_product_attention``'s (flash) and
     their bounds, each flash shape first held against the plain version
     in bf16 as in (d1), and the SSD's five stages timed apart at its
     three main-path shapes (mamba2-370m at 4,090 and 32,768 tokens,
     zamba2-7b-instruct at 4,090) beside what the states and output
     stages took on the CUDA cores.  ``python3 chip_smoke.py --phase 8`` runs
     phases 1 and 8 alone and prints their kernel records, no result;
  9. the training path, which reaches no kernel (plain, differentiable
     torch, as the JAX package's loss): (g1) ``python -m
     repro_torch.launch.train`` as a child process at smollm-135m's
     published config (30 layers, d 576, bf16 compute, float32 weights,
     remat full), 30 steps of 8 x 128 tokens — every loss finite, the
     last five's mean below the first five's, the final checkpoint
     restored on the card and its manifest held to the state's leaves
     and step; ms a step, tok/s, peak device memory, the checkpoint's
     bytes and save seconds printed; (g2) the same for mamba2-370m (48
     layers, d 1024, N 128), 10 steps; (g3) the drill at smollm-135m's
     published config — a reference run of 8 steps checkpointed every 4,
     a run killed at step 4 (exit 42) and its ``--resume`` (exit 0): the
     step-8 checkpoints' leaves equal byte for byte (params, m, v, step)
     and the final-loss lines equal; (g4) one ``make_train_step`` of each
     family's reduced config (float32) on the card and on the CPU from
     the same weights — loss, grad_norm and every gradient within 1e-4;
     flash and SSD launches read around the phase (and reported by each
     child) all 0; and where (g1)'s step goes (in this process: step ms
     with the launcher's deterministic settings and without, in turns,
     and a profiler window's kernel launches, device busy time and idle
     share a step);
 10. the device mesh (``repro_torch.launch.mesh``, ``distributed``):
     (h1) ``launch.train --mesh elastic`` at smollm-135m's published
     config, world 1 on NCCL, 5 steps of 8 x 128, against ``--mesh
     none`` (losses within 1e-5 relative; bit-equality printed); (h2) the
     same at ``--model-dim 2`` on two ranks of card 0 over gloo under
     ``torch.distributed.run`` (losses within 1e-4 of (h1), final params
     within 2e-4), then its ``--resume`` at world 1, model dim 1: every
     leaf saved again byte for byte; ms a step, peak memory a rank; (h3)
     ``compressed_psum`` over smollm-135m's gradient size (seeded draws)
     on those two ranks: within the bound of the float all-reduce,
     bit-equal to a 2-rank CPU gloo world, bytes on the wire, seconds;
     (h4) MoE expert parallelism at granite-moe-3b-a800m's widths cut to
     4 of 32 layers, float32, on (1, 2) over gloo: loss and gradient
     norm within 2e-3 of the world-1 dispatch path in this process,
     expert parallelism taken in every layer; (h5) the ``("cells",)``
     sweep mesh on two ranks: (a)'s DS_PGM grid over miss_penalty (its
     stacked build sharded) and (e)'s exhaustive grid, field for field
     equal to ``mesh=None`` on one rank, each rank's subset-DP launches
     equal to the single rank's; (h6) the data axes (below); (h7)
     tensor-parallel serving on two gloo ranks of card 0 on (1, 2):
     smollm-135m (9 heads on 2 ranks: every rank computes every head,
     ``wo`` row-parallel; the tied embedding vocab-parallel) and
     mamba2-370m (its SSM heads, state and conv cache on ``model``) at
     their published configs, batch 2, a TP_PROMPT-token prefill and
     TP_STEPS greedy decode steps fed world 1's tokens, against world 1
     from the same weights: float32 logits within DEC_TOL_F32 of the
     largest |logit| and tokens equal; bf16 weights within the arch's
     fixed TP_BF16_SHARE of world 1's, with the argmax equal where world
     1's top-two gap exceeds the error, and world 1 and the mesh each
     within that share of the float32 witness (the same bf16 weights
     computed in float32 on the card); each rank's parameter bytes
     and peak memory beside world 1's, its kernel launches (flash a
     layer, SSD a block) checked.  ``python3 chip_smoke.py --phase 10`` runs phases
     1, 6 and 10 alone and prints no result;
 11. the dry run (``repro_torch.launch.dryrun``): ``python -m
     repro_torch.launch.dryrun --all --mesh both --force`` as a child
     process, started right after phase 1 so that its host-only tracing
     runs beside phases 2-10 (no card: ``CUDA_VISIBLE_DEVICES`` empty),
     all 64 records checked (256 / 512 chips, FLOPs and bytes > 0, a
     bottleneck) and printed one line a cell beside the card's name and
     power limit; four cells' per-device steps run on the card under the
     cost trace against their meta traces — smollm-135m prefill_32k (flash
     at [2, 32768, 9/3, 64] bf16 causal), mamba2-370m prefill_32k (SSD at
     [2, 32768, 32, 64] N 128, chunk 256), smollm-135m decode_32k (B 8)
     and smollm-135m train_4k (16 x 4096 tokens, 22 GB of temporaries
     predicted): kernel launches (counts set to 0 just before) equal to
     the trace's calls, FLOPs equal, the trace's peak temporaries within
     ``PEAK_BAND`` of ``torch.cuda.max_memory_allocated`` above the step's
     baseline, the measured step time printed beside the roofline's; then
     flash at that 32k shape against its plain version over every query
     block of 2,048 rows (the whole [32768, 32768] scores do not fit) and
     the SSD at its 32k shape against its plain version whole, at (d1)'s
     tolerances, both timed beside their bounds (flash beside SDPA) and
     added to the kernels line.  ``python3 chip_smoke.py --phase 11`` runs
     phases 1 and 11 alone and prints no result.

(d2) was cut to make room for phase 11: the serve drives take 64, 48, 32,
32, 32 and 24 requests where they took 200, 100, 64, 64, 64 and 48; each
drive prints the seconds the cut saved (its prefill and decode seconds a
request times the requests cut), and the last lines print phase 11's
seconds and the sum saved.

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

import contextlib
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
#: dense bf16 on the tensor cores
PEAK_BF16_FLOPS = 989e12
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


#: numbers the last lines print: the (d2) cut's estimated seconds saved
RUN = {"d2_saved_s": 0.0}


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
    returns the subset-DP launches of each run and the cold grid."""
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
    return launches, cold


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

#: flash kernel checks: (name, B, Sq, Sk, Hq, Hkv, D) — the serve shapes of
#: smollm-135m (prefix 24, the launcher's default, and 512), a long
#: prefill, zamba2-7b's shared attention at its serve length (D = 112), a
#: seamless-m4t-medium cross attention with more frames than tokens and
#: zamba2-7b-instruct's shared attention at its benchmark's document
#: length (D = 224); each causal (the top-left mask where Sq != Sk) and
#: non-causal
FLASH_SHAPES = (("serve24", 1, 24, 24, 9, 3, 64),
                ("serve512", 1, 512, 512, 9, 3, 64),
                ("long2048", 1, 2048, 2048, 9, 3, 64),
                ("zamba512", 1, 512, 512, 32, 32, 112),
                ("cross256x384", 1, 256, 384, 16, 16, 64),
                ("instruct4090", 1, 4090, 4090, 32, 32, 224))
#: SSD checks: (name, b, s, h, p, n, chunk) — mamba2-370m's widths at the
#: padded serve length and at a 4096-token prefill, zamba2-7b's at its
#: serve length and zamba2-7b-instruct's at its benchmark's document length
SSD_SHAPES = (("serve300", 1, 300, 32, 64, 128, 256),
              ("long4096", 1, 4096, 32, 64, 128, 256),
              ("zamba512", 1, 512, 112, 64, 64, 256),
              ("instruct4090", 1, 4090, 112, 64, 64, 256))
#: a flash shape's or path's softmax scale where it is not D^-1/2:
#: zamba2-7b-instruct's (224/2)^-1/2
FLASH_SCALE = {"instruct4090": 112 ** -0.5, "zamba2-7b-instruct": 112 ** -0.5}
#: an SSD shape's or path's B/C groups where there are more than one
SSD_GROUPS = {"instruct4090": 2, "zamba2-7b-instruct": 2}
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
#: the SSD's three main-path shapes, timed stage by stage: (name, b, s, h,
#: p, n, chunk, groups, device ms a call of the states and output stages
#: on the CUDA cores, profiled on an NVIDIA H100 80GB HBM3 at 700 W); the
#: tensor-core stages are to take at most 1 / SSD_STAGE_GAIN of it
SSD_STAGE_SHAPES = (
    ("mamba2-370m-4090", 1, 4090, 32, 64, 128, 256, 1, 0.5415),
    ("zamba2-7b-instruct-4090", 1, 4090, 112, 64, 64, 256, 2, 1.6395),
    ("mamba2-370m-32768", 1, 32768, 32, 64, 128, 256, 1, 4.3440))
SSD_STAGE_GAIN = 4
#: the full-width serve drives at the published configs: (arch, launcher
#: flags, kernel launches a prefill).  Prefix lengths are multiples of 16
#: (granite's ``moe_groups``); zamba2-7b's requests stay few because each
#: cached prefix holds 149 MB of SSD state beside 28 GB of weights, and
#: zamba2-7b-instruct's because each holds 1.68 GB beside 29 GB.  The
#: request counts were cut to make room for phase 11 (``SERVE_CUT``: the
#: counts before; zamba2-7b-instruct's drive came later, uncut)
SERVE_DRIVES = (
    ("smollm-135m", ["--prefix-len", "512", "--requests", "64"],
     {"flash_attention": 30, "ssd_scan": 0}),
    ("mamba2-370m", ["--prefix-len", "300", "--requests", "48"],
     {"flash_attention": 0, "ssd_scan": 48}),
    ("granite-moe-3b-a800m", ["--prefix-len", "512", "--requests", "32"],
     {"flash_attention": 32, "ssd_scan": 0}),
    ("internvl2-1b", ["--prefix-len", "64", "--requests", "32"],
     {"flash_attention": 24, "ssd_scan": 0}),
    ("seamless-m4t-medium", ["--prefix-len", "256", "--requests", "32"],
     {"flash_attention": 36, "ssd_scan": 0}),
    ("zamba2-7b", ["--prefix-len", "512", "--requests", "24"],
     {"flash_attention": 13, "ssd_scan": 81}),
    ("zamba2-7b-instruct", ["--prefix-len", "4090", "--requests", "12"],
     {"flash_attention": 13, "ssd_scan": 81}),
)
SERVE_CUT = {"smollm-135m": 200, "mamba2-370m": 100,
             "granite-moe-3b-a800m": 64, "internvl2-1b": 64,
             "seamless-m4t-medium": 64, "zamba2-7b": 48,
             "zamba2-7b-instruct": 12}
#: the flash launches of each drive's prefill, by shape: (path, B, Sq, Sk,
#: Hq, Hkv, D, causal, launches a prefill) — internvl2-1b's prompt is its
#: 1,024 patches and 64 tokens; seamless's frames are as long as its
#: tokens in the launcher
FLASH_PATHS = (
    ("smollm-135m", 1, 512, 512, 9, 3, 64, True, 30),
    ("granite-moe-3b-a800m", 1, 512, 512, 24, 8, 64, True, 32),
    ("internvl2-1b", 1, 1088, 1088, 14, 2, 64, True, 24),
    ("seamless-m4t-medium encoder", 1, 256, 256, 16, 16, 64, False, 12),
    ("seamless-m4t-medium decoder self", 1, 256, 256, 16, 16, 64, True, 12),
    ("seamless-m4t-medium decoder cross", 1, 256, 256, 16, 16, 64, False,
     12),
    ("zamba2-7b", 1, 512, 512, 32, 32, 112, True, 13),
    ("zamba2-7b-instruct", 1, 4090, 4090, 32, 32, 224, True, 13))
#: the SSD calls of each drive's prefill: (path, b, s, h, p, n, chunk,
#: calls a prefill)
SSD_PATHS = (("mamba2-370m", 1, 300, 32, 64, 128, 256, 48),
             ("zamba2-7b", 1, 512, 112, 64, 64, 256, 81),
             ("zamba2-7b-instruct", 1, 4090, 112, 64, 64, 256, 81))
#: full-width float32 card vs CPU: (prompt tokens, encoder frames, config
#: overrides) per model.  Two depth cuts spare the CPU's float32 time and
#: the host's memory: zamba2-7b keeps 12 of its 81 Mamba blocks (2 shared
#: applications, so both shared blocks run), granite-moe-3b-a800m 8 of its
#: 32 layers; every width is the published one and the other models run
#: at full depth.  seamless's 384 frames against 256 tokens make its cross
#: attention Sq != Sk on the card.
LM_COMPARE = {"smollm-135m": (512, 0, {}), "mamba2-370m": (300, 0, {}),
              "granite-moe-3b-a800m": (256, 0, {"n_layers": 8}),
              "internvl2-1b": (64, 0, {}),
              "seamless-m4t-medium": (256, 384, {}),
              "zamba2-7b": (512, 0, {"n_layers": 12})}
LM_DECODE_STEPS = 8
#: logits and caches within LOGIT_TOL (rtol and atol): float32 on both
#: sides, cuBLAS and the CPU's BLAS sum in other orders across the layers
LOGIT_TOL = 2e-3
#: MoE routing: card and CPU router products differ by ~1e-6 relative
#: in float32, so where a token's k-th and (k+1)-th router probabilities
#: lie within this relative gap on the CPU the card may choose another
#: expert; outside it the card must choose the CPU's experts
ROUTE_DEAD_BAND = 1e-5


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


def _flash_inputs(b, sq, sk, hq, hkv, d, dtype, dev, seed):
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _ssd_inputs(b, s, h, p, n, dtype, dev, seed, groups=1):
    """x, B, C standard normal; dt = softplus(N(0,1) - 1) and A = -exp(U)
    as the JAX kernel tests draw them; dt and A float32.  B and C are
    [b, s, n], or [b, s, groups, n] where ``groups`` > 1."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev) - 1.0)
    A = -torch.exp(torch.rand(h, generator=g, device=dev) * 2.0 - 1.0)
    bc = (b, s, n) if groups == 1 else (b, s, groups, n)
    B = torch.randn(bc, generator=g, device=dev).to(dtype)
    C = torch.randn(bc, generator=g, device=dev).to(dtype)
    return x, dt, A, B, C


def phase_lm_kernel_checks(dev) -> dict:
    """(d1) Each LM kernel against its plain version on the card
    (comparison launches; they do not count towards the main path).
    Returns the largest error per kernel at the main path's type (bf16)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    errs = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for name, b, sq, sk, hq, hkv, d in FLASH_SHAPES:
        scale = FLASH_SCALE.get(name)
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_TOL[str(dtype)[6:]]
            q, k, v = _flash_inputs(b, sq, sk, hq, hkv, d, dtype, dev, sq)
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
                sync()
                want = fa.flash_attention_ref(q, k, v, causal=causal,
                                              scale=scale)
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
                    errs["flash_attention"] = max(errs["flash_attention"],
                                                  err)
                print(f"[lm kernel] flash {name} [{b}, {sq} x {sk}, {hq}/"
                      f"{hkv}, {d}] scale {scale or d ** -0.5!r} "
                      f"{str(dtype)[6:]} causal={causal}: max "
                      f"|kernel - plain| {err!r} (tol {tol}){extra}")
    for name, b, s, h, p, n, chunk in SSD_SHAPES:
        groups = SSD_GROUPS.get(name, 1)
        for dtype in (torch.float32, torch.bfloat16):
            tol = SSD_TOL[str(dtype)[6:]]
            x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, dtype, dev, s,
                                         groups)
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
                if dtype == torch.bfloat16 and init is None:
                    errs["ssd_scan"] = max(errs["ssd_scan"], err)
                print(f"[lm kernel] ssd {name} [{b}, {s}, {h}, {p}] n={n} "
                      f"groups={groups} {str(dtype)[6:]} "
                      f"initial_state={init is not None}: "
                      f"max |kernel - plain| y {err!r}, state {serr!r} (tol "
                      f"{tol})")
    return errs


def _serve_line(text: str) -> dict:
    import re
    last = [ln for ln in text.splitlines() if "policy=" in ln][-1]
    out = {"prefills": int(re.search(r"\bprefills=(\d+)", last).group(1))}
    drawn = re.search(r"\[serve\] weights arch=\S+ params=(\d+) drawn on "
                      r"(\w+) in ([0-9.]+)s", text)
    out["params"], out["draw_s"] = int(drawn.group(1)), float(drawn.group(3))
    decoded = re.search(r"\[serve\] decoded tokens=(\d+) in ([0-9.]+)s "
                        r"\(prefill ([0-9.]+)s\)", text)
    out["tokens"], out["prefill_s"] = (int(decoded.group(1)),
                                       float(decoded.group(3)))
    out["decode_s"] = float(decoded.group(2)) - out["prefill_s"]
    return out


def host_draw_ns(n: int = 50_000_000) -> float:
    """Host nanoseconds per truncated-normal float32 value, as
    ``models.layers.dense_init`` draws them with a CPU generator."""
    import torch
    w = torch.empty(n)
    t0 = time.perf_counter()
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(0))
    return (time.perf_counter() - t0) / n * 1e9


def phase_lm_serve(card: str) -> dict:
    """(d2) The serving launcher at each published config on the card,
    kernel launches read around each drive and checked exactly against
    the per-prefill counts; returns {arch: (prefills, launches)}."""
    import contextlib
    import gc
    import io
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.serve import main as serve_main
    out = {}
    for arch, flags, per_prefill in SERVE_DRIVES:
        argv = ["--arch", arch, "--no-reduced", "--device", "cuda"] + flags
        fa.reset_launches()
        ssd.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_main(argv)
        secs = time.perf_counter() - t0
        counts = {**fa.LAUNCHES, **ssd.LAUNCHES}
        mma = ssd.MMA_LAUNCHES["ssd_scan_mma"]
        print(buf.getvalue(), end="")
        check(rc == 0, f"serve {arch} exited {rc}")
        st = _serve_line(buf.getvalue())
        n = st["prefills"]
        want = {k: v * n for k, v in per_prefill.items()}
        tokens, decode_s = st["tokens"], st["decode_s"]
        print(f"[lm serve] {arch} published config ({st['params']} "
              f"parameters, drawn on the card in {st['draw_s']} s): {n} "
              f"prefills in {st['prefill_s']} s ({st['prefill_s'] / n:.4f} s "
              f"each); decode {tokens} tokens in {decode_s:.1f} s = "
              f"{tokens / decode_s:.2f} tok/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; kernel "
              f"launches {json.dumps(counts)} = {json.dumps(per_prefill)} "
              f"x {n} prefills, {mma} SSD calls on the tensor cores "
              f"(ssd_scan_mma); {secs:.3f} s in all ({card})")
        check(n > 0 and counts == want,
              f"{arch}: kernel launches {counts}, expected {want}")
        # bf16 compute: every SSD call runs the tensor-core stages
        check(mma == counts["ssd_scan"],
              f"{arch}: {mma} SSD calls on the tensor cores of "
              f"{counts['ssd_scan']}")
        out[arch] = (n, counts, st["params"])
        requests = int(flags[flags.index("--requests") + 1])
        saved = (st["prefill_s"] + decode_s) * (SERVE_CUT[arch] / requests
                                                - 1)
        RUN["d2_saved_s"] += saved
        print(f"[lm serve] (d2) cut: {arch} {SERVE_CUT[arch]} -> {requests} "
              f"requests, about {saved:.1f} s saved (this drive's prefill "
              f"and decode seconds a request x the requests cut) ({card})")
        gc.collect()
        torch.cuda.empty_cache()
    ns = host_draw_ns()
    big = max(p for _, _, p in out.values())
    print(f"[lm serve] the host CPU draws a truncated-normal float32 value in "
          f"{ns:.2f} ns (5e7 drawn): the largest drive's {big} weights would "
          f"take {big * ns / 1e9:.1f} s there; the launcher draws them on the "
          f"card ({card})")
    return out


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


@contextlib.contextmanager
def _routes_held():
    """While open, each CPU MoE routing queues its expert choice, and each
    card routing (the same calls in the same order) is held to it: every
    token's expert set on the card must equal the CPU's unless the CPU's
    relative gap between the token's k-th and (k+1)-th router probability
    lies inside ``ROUTE_DEAD_BAND``.  Such a token then takes the CPU's
    experts, weighted by the card's own probabilities, so that card and
    CPU logits stay comparable at every step.  Yields the tally: routings
    held, the smallest CPU gap, the tokens that took the CPU's choice."""
    import torch
    from repro_torch.models import layers
    orig, queue = layers.moe_route, []
    tally = {"routings": 0, "min_gap": float("inf"), "in_band": 0}

    def probs(p, x, cfg):
        logits = x.float() @ p["router"].float()
        logits[..., cfg.n_experts:] = -1e30
        return torch.softmax(logits, -1)

    def held(p, x, cfg):
        topw, topi = orig(p, x, cfg)
        if x.device.type == "cpu":
            with torch.no_grad():
                top = probs(p, x, cfg).topk(cfg.topk + 1, -1).values
            gap = (top[..., -2] - top[..., -1]) / top[..., -2]
            tally["min_gap"] = min(tally["min_gap"], float(gap.min()))
            queue.append((topi, gap))
            return topw, topi
        want, gap = queue.pop(0)
        tally["routings"] += 1
        differ = (topi.sort(-1).values.cpu()
                  != want.sort(-1).values).any(-1)
        check(not bool((differ & (gap >= ROUTE_DEAD_BAND)).any()),
              f"MoE routing {tally['routings']}: the card chose other "
              f"experts than the CPU outside the dead-band")
        if not bool(differ.any()):
            return topw, topi
        tally["in_band"] += int(differ.sum())
        idx = want.to(x.device)
        w = probs(p, x, cfg).gather(-1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx

    layers.moe_route = held
    try:
        yield tally
    finally:
        layers.moe_route = orig
    check(not queue, f"{len(queue)} CPU MoE routings had no card routing")


def _lm_compare(arch: str, dev, card: str) -> None:
    """(d3) Published widths, float32, seeded weights (drawn on the card,
    copied to the CPU): prefill logits and the cache, then greedy decode
    on the CPU and the card fed the CPU's tokens, every step held to
    ``LOGIT_TOL``; the card's greedy choice must match the CPU's wherever
    the CPU's top-2 gap exceeds twice the logit tolerance.  An MoE model's
    routings are held to the CPU's by ``_routes_held``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    s, n_frames, over = LM_COMPARE[arch]
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    model = get_model(cfg)
    params_card = init_params(cfg, torch.Generator(dev).manual_seed(7), dev)
    params = _to_device(params_card, "cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, s)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.n_patches, cfg.d_model), dtype=np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (1, n_frames, cfg.d_model), dtype=np.float32))
    n = s + cfg.n_patches if cfg.family == "vlm" else s
    kw = {} if cfg.family == "ssm" else {"max_len": n + LM_DECODE_STEPS}
    with torch.no_grad(), _routes_held() as routes:
        t0 = time.perf_counter()
        lg_c, cache_c = model.prefill(params, batch, **kw)
        cpu_s = time.perf_counter() - t0
        lg_g, cache_g = model.prefill(
            params_card, {k: v.to(dev) for k, v in batch.items()}, **kw)
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
    depth = (f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
             if over else "full depth")
    route = (f"; {routes['routings']} MoE routings held to the CPU's, "
             f"smallest relative gap {routes['min_gap']:.3e}, "
             f"{routes['in_band']} tokens inside the dead-band "
             f"{ROUTE_DEAD_BAND} took the CPU's experts"
             if routes["routings"] else "")
    print(f"[lm compare] {arch} published widths, {depth}, float32, prompt "
          f"{n}{f' + {n_frames} frames' if n_frames else ''}: prefill + "
          f"{LM_DECODE_STEPS} greedy decode steps, max |card - CPU| logit "
          f"{worst!r} (tol {LOGIT_TOL}), greedy tokens equal in "
          f"{LM_DECODE_STEPS - flips} of {LM_DECODE_STEPS} steps (near-tie "
          f"flips allowed){route}; CPU prefill {cpu_s:.3f} s ({card})")


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name, without namespace and signature."""
    import re
    found = re.search(r"(\w+_kernel(?:_mma)?)\b", key)
    return found.group(1) if found else key[:40]


def _time_flash(name, b, sq, sk, hq, hkv, d, causal, dev, card,
                scale=None) -> dict:
    """bf16 flash at one shape and softmax scale (D^-1/2 where None):
    first the kernel against its plain version on these inputs (3e-2, and
    the one-ulp share check of (d1)), then the kernel and SDPA in turns
    (SDPA, kernel, kernel, SDPA; the better of two each), the plain
    version, the bound.  ``err`` is the check's largest |kernel -
    plain|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_work
    q, k, v = _flash_inputs(b, sq, sk, hq, hkv, d, torch.bfloat16, dev,
                            sq + d)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kern = lambda: fa.flash_attention(q, k, v,  # noqa: E731
                                      causal=causal, scale=scale)
    plain = lambda: fa.flash_attention_ref(q, k, v,  # noqa: E731
                                           causal=causal, scale=scale)
    got = kern()
    sync()
    want = plain()
    err, ok = _err(got, want, FLASH_TOL["bfloat16"])
    share, in_ulp = _bf16_ulp_close(got, want)
    mask = "causal" if causal else "non-causal"
    check(ok and in_ulp and share <= FLASH_BF16_SHARE,
          f"flash {name} bf16 {mask}: kernel != plain (max |err| {err}, "
          f"{share:.2%} of outputs differ, within one ulp: {in_ulp})")
    print(f"[lm kernel] flash {name} [{b}, {sq} x {sk}, {hq}/{hkv}, {d}] "
          f"bfloat16 {mask}: max |kernel - plain| {err!r} (tol "
          f"{FLASH_TOL['bfloat16']}); {share:.3%} of outputs differ, all "
          f"within one bf16 ulp (limit {FLASH_BF16_SHARE:.0%})")
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True, scale=scale)
    lib1, ms1, ms2, lib2 = (device_ms(f, 50) for f in (sdpa, kern, kern,
                                                       sdpa))
    ms, lib_ms = min(ms1, ms2), min(lib1, lib2)
    plain_ms = device_ms(plain, 5)
    flops, nbytes = flash_work(b, sq, sk, hq, hkv, d, causal, 2)
    bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"[times] flash_attention {name} bf16 {mask} [{b}, {sq} x {sk}, "
          f"{hq}/{hkv}, {d}]: device time "
          f"kernel {ms:.4f} ms ({ms1:.4f}, {ms2:.4f}), plain {plain_ms:.4f} "
          f"ms, SDPA {lib_ms:.4f} ms ({lib1:.4f}, {lib2:.4f}); bound "
          f"{bound_ms:.6f} ms ({by}; {flops} flops, {nbytes} bytes), "
          f"{bound_ms / ms:.1%} of the bound reached ({card})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms, "err": err}


def _time_ssd(name, b, s, h, p, n, chunk, dev, card, groups=1) -> dict:
    """bf16 SSD at one shape (B and C in ``groups`` groups): the kernel
    (five stages), the plain version, the bound; the stages' device times
    from a profiler trace (log)."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ssd import ssd_work
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, s,
                                 groups)
    kern = lambda: ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)  # noqa: E731
    ms = device_ms(kern, 20)
    stages = kernel_shares(kern, 20)
    plain_ms = device_ms(lambda: ssd.ssd_scan_ref(x, dt, A, B, C,
                                                  chunk=chunk), 3)
    cb_flops, flops, nbytes = ssd_work(b, s, h, p, n, chunk, 2, groups)
    # every product has bf16 operands and runs on the tensor cores
    bound_ms, by = bound(cb_flops + flops, nbytes, PEAK_BF16_FLOPS)
    print(f"[times] ssd_scan {name} bf16 [{b}, {s}, {h}, {p}] n={n} "
          f"groups={groups} chunk={chunk}: device time kernel {ms:.4f} ms "
          f"(five kernels), plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({by}; "
          f"{cb_flops} flops of C.B^T, {flops} of the other products, "
          f"{nbytes} bytes), {bound_ms / ms:.1%} of the bound reached "
          f"({card})")
    print(f"[times] ssd_scan {name} stages (device ms a launch, profiler "
          f"trace): " + ", ".join(f"{_kernel_name(k)} {v:.4f}"
                                  for k, v in stages.items()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def _time_ssd_stages(name, b, s, h, p, n, chunk, groups, before_ms, dev,
                     card) -> None:
    """The five stages of one bf16 SSD call at a main-path shape, timed
    apart (a profiler trace, the log only), beside the call's bound (every
    product at the bf16 tensor-core peak, as the benchmark's
    ``ssd_roofline`` counts it) and ``before_ms``, what the states and
    output stages took on the CUDA cores."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ssd import ssd_work
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, s,
                                 groups)
    kern = lambda: ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)  # noqa: E731
    ms = device_ms(kern, 20)
    stages = {_kernel_name(k): v for k, v in kernel_shares(kern, 20).items()}
    cb_flops, flops, nbytes = ssd_work(b, s, h, p, n, chunk, 2, groups)
    bound_ms, by = bound(cb_flops + flops, nbytes, PEAK_BF16_FLOPS)
    two = sum(v for k, v in stages.items()
              if k.startswith(("ssd_states_kernel", "ssd_out_kernel")))
    print(f"[times] ssd_scan stages {name} bf16 [{b}, {s}, {h}, {p}] n={n} "
          f"groups={groups} chunk={chunk} (device ms a launch, profiler "
          f"trace): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; the call {ms:.4f} ms (events), bound {bound_ms:.6f} ms ({by}); "
          f"states + output {two:.4f} ms against {before_ms:.4f} on the CUDA "
          f"cores ({before_ms / two:.2f}x less, {SSD_STAGE_GAIN}x asked: "
          f"{'met' if before_ms >= SSD_STAGE_GAIN * two else 'missed'}) "
          f"({card})")


def phase_lm_times(dev, serve: dict, errs: dict, card: str):
    """(d4) Kernel, plain version and (flash) SDPA times at each main-path
    shape, beside each one's bound, then at the long and cross shapes (log
    only); returns the two records.  A record's ``per_launch`` holds one
    launch at each main-path shape with that path's launch count; its
    ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` sum them.  Each
    flash shape is first held against the plain version in bf16, and the
    record's ``max_abs_err`` is the largest bf16 error of (d1) and (d4)."""
    flash, ssd_entries = [], []
    for path, b, sq, sk, hq, hkv, d, causal, per in FLASH_PATHS:
        n = serve[path.split()[0]][0]
        t = _time_flash(path, b, sq, sk, hq, hkv, d, causal, dev, card,
                        FLASH_SCALE.get(path))
        errs["flash_attention"] = max(errs["flash_attention"], t.pop("err"))
        flash.append({"launch": f"{path} [{b}, {sq} x {sk}, {hq}/{hkv}, {d}]"
                                f" {'causal' if causal else 'non-causal'}",
                      "launches": per * n, **t})
    for name, b, sq, sk, hq, hkv, d in FLASH_SHAPES:
        if name in ("long2048", "cross256x384"):
            t = _time_flash(name, b, sq, sk, hq, hkv, d, name == "long2048",
                            dev, card)
            errs["flash_attention"] = max(errs["flash_attention"], t["err"])
    for path, b, s, h, p, n_, chunk, per in SSD_PATHS:
        groups = SSD_GROUPS.get(path, 1)
        t = _time_ssd(path, b, s, h, p, n_, chunk, dev, card, groups)
        ssd_entries.append({"launch": f"{path} [{b}, {s}, {h}, {p}] n={n_} "
                                      f"groups={groups} chunk={chunk}",
                            "launches": per * serve[path][0], **t})
    _time_ssd("long4096", *SSD_SHAPES[1][1:], dev, card)
    for stage_shape in SSD_STAGE_SHAPES:
        _time_ssd_stages(*stage_shape, dev, card)
    records = []
    for name, kernel, entries, source, replaces in (
            ("flash_attention.flash_attention", "flash_attention", flash,
             "flash_attention/csrc/flash_wgmma.cu",
             "flash_attention/flash.py:32"),
            ("ssd.ssd_scan", "ssd_scan", ssd_entries, "ssd/csrc/ssd.cu",
             "ssd/ssd.py:28")):
        launches = sum(e["launches"] for e in entries)
        on_path = sum(c[kernel] for _, c, _ in serve.values())
        check(launches == on_path, f"{kernel}: per-path launches {launches} "
                                   f"!= {on_path} on the drives")
        total = _summed(f"{kernel}, one launch at each main-path shape",
                        entries, card)
        libs = [e["library_ms"] for e in entries]
        records.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches, "max_abs_err": errs[kernel],
            "library_ms": None if None in libs else sum(libs), **total})
    return records


def phase_lm(dev, card: str):
    """Phase 8: the LM serving path; returns the two kernel records."""
    errs = phase_lm_kernel_checks(dev)
    serve = phase_lm_serve(card)
    for arch in LM_COMPARE:
        _lm_compare(arch, dev, card)
    return phase_lm_times(dev, serve, errs, card)


# ---------------------------------------------------------------------------
# the training path (no kernel: plain, differentiable torch)
# ---------------------------------------------------------------------------

#: (g1), (g2): (arch, steps) of the launcher at the published config
TRAIN_DRIVES = (("smollm-135m", 30), ("mamba2-370m", 10))
TRAIN_SHAPE = ("--batch", "8", "--seq", "128")
#: (g3) the drill at smollm-135m's published config: a reference run of
#: ``DRILL_STEPS`` steps checkpointed every ``DRILL_INTERVAL``, a run
#: killed at ``DRILL_KILL`` (exit 42) and its ``--resume``
DRILL_STEPS, DRILL_INTERVAL, DRILL_KILL = 8, 4, 4
#: (g4) one train step of each family's reduced config (float32), card
#: against CPU
TRAIN_COMPARE = ("smollm-135m", "granite-moe-3b-a800m", "internvl2-1b",
                 "mamba2-370m", "zamba2-7b", "seamless-m4t-medium")
TRAIN_TOL = 1e-4


def _train(args, ckpt_dir: Path):
    """``python -m repro_torch.launch.train`` on the card as a child
    process: (exit code, stdout, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
         "--ckpt-dir", str(ckpt_dir), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode not in (0, 42):
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
    return proc.returncode, proc.stdout, secs


def _train_log(out: str) -> dict:
    """The launcher's step lines (loss, tok/s), its final-loss line and its
    summary object."""
    import re
    steps = [(int(m.group(1)), float(m.group(2)),
              float(m.group(3).replace(",", "")))
             for m in re.finditer(r"\[train\] step +(\d+) loss (\S+) gnorm "
                                  r"\S+ ([0-9,.]+) tok/s", out)]
    final = [ln for ln in out.splitlines() if "final loss" in ln]
    summary = out.split("[train] summary ", 1)
    return {"steps": steps, "final": final[0] if final else None,
            "summary": json.loads(summary[1].splitlines()[0])
            if len(summary) == 2 else None}


def _no_launches(summary: dict, what: str) -> None:
    check(summary["kernel_launches"] == {"flash_attention": 0,
                                         "ssd_scan": 0},
          f"{what}: the training path launched a kernel "
          f"{summary['kernel_launches']}")


def _train_drive(arch: str, steps: int, root: Path, card: str) -> None:
    """(g1)/(g2) the launcher at the published config: finite, falling
    loss; the final checkpoint restored on the card, its manifest held to
    the state's leaves."""
    import math
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import OptConfig, init_train_state
    from repro_torch.tree import tree_paths
    ckpt = root / arch
    rc, out, secs = _train(["--arch", arch, "--steps", str(steps),
                            *TRAIN_SHAPE, "--log-every", "1"], ckpt)
    check(rc == 0, f"train {arch} exited {rc}")
    log = _train_log(out)
    losses = [loss for _, loss, _ in log["steps"]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"train {arch}: losses {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"train {arch}: loss did not fall ({first} -> "
                        f"{last})")
    _no_launches(log["summary"], f"train {arch}")
    cfg = get_config(arch)
    like = init_train_state(init_params(cfg, device="cuda"), OptConfig())
    manifest = json.loads((ckpt / f"step_{steps}" / "manifest.json")
                          .read_text())
    check(manifest["step"] == steps, f"{arch}: checkpoint step "
                                     f"{manifest['step']}")
    state = restore(ckpt, like, device="cuda")
    n = 0
    for path, leaf in tree_paths(state):
        key = "::".join(str(p) for p in path)
        want = {"shape": list(leaf.shape),
                "dtype": str(leaf.dtype).replace("torch.", "")}
        check(manifest["leaves"][key] == want, f"{arch} {key}: manifest "
              f"{manifest['leaves'][key]}, state {want}")
        check(bool(torch.isfinite(leaf.float()).all()), f"{arch} {key} not "
                                                        f"finite")
        n += 1
    check(n == len(manifest["leaves"]) and int(state["step"]) == steps,
          f"{arch}: {n} leaves restored of {len(manifest['leaves'])}")
    tokens = 8 * 128
    rates = [tps for s, _, tps in log["steps"] if s > 0]
    ms = [tokens / tps * 1e3 for tps in rates]
    sm = log["summary"]
    print(f"[train] {arch} published config ({cfg.param_count()} "
          f"parameters, remat {cfg.remat}, {cfg.dtype} compute, "
          f"{cfg.param_dtype} weights), {steps} steps of 8 x 128 tokens: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first five "
          f"{first:.4f}, last five {last:.4f}); {sum(ms) / len(ms):.1f} ms "
          f"a step, {tokens * len(ms) / sum(ms) * 1e3:,.0f} tok/s (steps "
          f"1-{steps - 1}); peak device memory "
          f"{sm['peak_memory_bytes'] / 1e9:.3f} GB; checkpoint "
          f"{sm['ckpt_bytes']} bytes saved in {sm['ckpt_save_s']:.3f} s, "
          f"restored on the card ({n} leaves, step {steps}); kernel "
          f"launches {json.dumps(sm['kernel_launches'])}; {secs:.1f} s "
          f"with the process start ({card})")


def _train_drill(root: Path, card: str) -> None:
    """(g3) preempt and resume at smollm-135m's published config: the
    resumed run's last checkpoint equals the reference run's leaf for
    leaf, byte for byte, and its final-loss line is the same."""
    import numpy as np
    common = ["--arch", "smollm-135m", "--steps", str(DRILL_STEPS),
              *TRAIN_SHAPE, "--ckpt-interval", str(DRILL_INTERVAL)]
    rc_ref, out_ref, s_ref = _train(common, root / "ref")
    check(rc_ref == 0, f"drill reference run exited {rc_ref}")
    rc_kill, out_kill, s_kill = _train(
        common + ["--kill-at", str(DRILL_KILL)], root / "run")
    check(rc_kill == 42, f"drill killed run exited {rc_kill}, not 42")
    rc_res, out_res, s_res = _train(common + ["--resume"], root / "run")
    check(rc_res == 0, f"drill resumed run exited {rc_res}")
    check(f"resumed from step {DRILL_KILL}" in out_res,
          "drill: the resumed run did not start from the kill step")
    ref, res = _train_log(out_ref), _train_log(out_res)
    _no_launches(ref["summary"], "drill reference")
    _no_launches(res["summary"], "drill resumed")
    check(ref["final"] is not None and ref["final"] == res["final"],
          f"drill final loss: {ref['final']} vs {res['final']}")
    last = f"step_{DRILL_STEPS}/arrays.npz"
    with np.load(root / "ref" / last) as a, np.load(root / "run" / last) as b:
        check(sorted(a.files) == sorted(b.files), "drill: other leaves")
        same = [a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
                for k in a.files]
        nbytes = sum(a[k].nbytes for k in a.files)
    check(all(same), f"drill: {same.count(False)} of {len(same)} leaves "
                     f"differ after the resume")
    print(f"[train] drill smollm-135m published config: reference "
          f"{DRILL_STEPS} steps (checkpoint every {DRILL_INTERVAL}), a run "
          f"killed at step {DRILL_KILL} (exit 42), its --resume (exit 0): "
          f"step {DRILL_STEPS}'s {len(same)} leaves ({nbytes} bytes of "
          f"params, m, v, step) equal byte for byte; final-loss line "
          f"'{res['final']}' in both; {s_ref:.1f} + {s_kill:.1f} + "
          f"{s_res:.1f} s ({card})")


def _train_compare(arch: str, dev, card: str) -> None:
    """(g4) one ``make_train_step`` of ``arch``'s reduced config (float32)
    on the card and on the CPU from the same weights (drawn on the CPU):
    loss, grad_norm and every gradient within ``TRAIN_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import (OptConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.tree import tree_leaves, tree_paths
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(11), "cpu")
    host = SyntheticLMData(DataConfig(batch=2, seq=32, seed=11),
                           model_cfg=cfg).batch_at(0)
    ocfg = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(model, ocfg)
    out = {}
    with _routes_held() as routes:
        for d in ("cpu", dev):
            batch = to_device(host, d)
            p = _to_device(params, d)
            (loss, _), grads = loss_and_grads(model, p, batch)
            _, metrics = step(init_train_state(p, ocfg), batch)
            out[str(d)] = (loss, metrics, grads)
    (l_c, m_c, g_c), (l_g, m_g, g_g) = out["cpu"], out[str(dev)]
    worst = 0.0
    for name, got, want in [("loss", l_g, l_c),
                            ("step loss", m_g["loss"], m_c["loss"]),
                            ("grad_norm", m_g["grad_norm"],
                             m_c["grad_norm"])] + [
            ("grad " + "::".join(map(str, path)), g, w)
            for (path, g), w in zip(tree_paths(g_g), tree_leaves(g_c))]:
        e, ok = _err(got.cpu(), want, TRAIN_TOL)
        check(ok, f"{arch} train step: {name} card != CPU (max |err| {e})")
        worst = max(worst, e)
    print(f"[train compare] {arch} reduced ({cfg.family}, float32): loss "
          f"{float(l_c):.6f}, grad_norm {float(m_c['grad_norm']):.6f}; "
          f"loss, grad_norm and {len(tree_leaves(g_c))} gradients card vs "
          f"CPU max |err| {worst!r} (tol {TRAIN_TOL})"
          + (f"; {routes['routings']} MoE routings held to the CPU's, "
             f"{routes['in_band']} tokens in the dead-band"
             if routes["routings"] else "") + f" ({card})")


def _train_profile(dev, card: str) -> None:
    """Where (g1)'s step goes, in this process at smollm-135m's published
    config: step ms (host clock to a device sync) with the launcher's
    deterministic settings and without, in turns, then one
    ``torch.profiler`` window of two steps: kernel launches a step, device
    busy ms a step (the sum of the kernels' own times; the profiler can
    miss records on that host, so a floor) and the idle share, and the
    host ops that take the most time."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.launch.train import deterministic
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import OptConfig, init_train_state, make_train_step
    cfg = get_config("smollm-135m")
    step = make_train_step(get_model(cfg), OptConfig())
    state = init_train_state(init_params(cfg, device=dev), OptConfig())
    data = SyntheticLMData(DataConfig(batch=8, seq=128), model_cfg=cfg)
    batches = [to_device(data.batch_at(i), dev) for i in range(4)]

    def run(n):
        nonlocal state
        out = []
        for i in range(n):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batches[i % 4])
            float(m["loss"])
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    run(2)
    ms = {True: [], False: []}
    for det in (True, False, False, True):
        if det:
            with deterministic():
                ms[det] += run(4)
        else:
            ms[det] += run(4)
    with deterministic(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        wall = (time.perf_counter() - t0) * 1e3 / 2
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel")) / 2
    busy = sum(e.self_device_time_total for e in events) / 1e3 / 2
    top = sorted((e for e in events if e.key.startswith(("aten::", "Mm"))),
                 key=lambda e: -e.self_cpu_time_total)[:4]
    print(f"[train profile] smollm-135m published config, 8 x 128 tokens a "
          f"step: median ms a step {statistics.median(ms[True]):.1f} with "
          f"the launcher's deterministic settings, "
          f"{statistics.median(ms[False]):.1f} without (8 steps each, in "
          f"turns); profiled window (deterministic, 2 steps): "
          f"{wall:.1f} ms a step, {launches:.0f} kernel launches a step, "
          f"device busy {busy:.1f} ms a step (profiler; a floor), idle "
          f"share {1 - busy / wall:.3f}; most host time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / 2:.1f} ms "
                      f"({e.count // 2} calls)" for e in top)
          + f" a step ({card})")


def phase_train(dev, card: str) -> None:
    """Phase 9: the training path on the card; flash and SSD launch
    counts read around it (the children report their own) stay 0."""
    import shutil
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    fa.reset_launches()
    ssd.reset_launches()
    t0 = time.perf_counter()
    try:
        for arch, steps in TRAIN_DRIVES:
            _train_drive(arch, steps, root, card)
        _train_profile(dev, card)
        _train_drill(root / "drill", card)
        for arch in TRAIN_COMPARE:
            _train_compare(arch, dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = {**fa.LAUNCHES, **ssd.LAUNCHES}
    check(counts == {"flash_attention": 0, "ssd_scan": 0},
          f"the training phase launched kernels in-process: {counts}")
    print(f"[train] phase 9: {time.perf_counter() - t0:.1f} s; flash and "
          f"SSD launches {json.dumps(counts)} here and 0 in every child "
          f"({card})")


# ---------------------------------------------------------------------------
# the device mesh (phase 10)
# ---------------------------------------------------------------------------

#: (h1)/(h2): smollm-135m's published config, steps of 8 x 128 tokens
MESH_STEPS = 5
#: (h1) elastic world 1 vs --mesh none; (h2) two ranks vs (h1)
MESH_TOL_H1, MESH_TOL_H2, MESH_PARAM_TOL = 1e-5, 1e-4, 2e-4
#: (h3) seed of the gradients' draws (rank r draws with seed + r)
COMP_SEED = 1900
#: (h4) granite-moe-3b-a800m's published widths cut to this many layers,
#: a batch of 2 x 256 tokens, float32, capacity factor 8
MOE_LAYERS, MOE_BATCH, MOE_SEQ, MOE_CAP, MOE_TOL = 4, 2, 256, 8.0, 2e-3
MOE_SEED = 19
#: (h6) the data axes on two ranks of card 0: smollm-135m's published
#: config in float32, DP_STEPS steps of 8 x 128 tokens on (data 2, model
#: 1), row r of the batch masked to its first 128 - 12 r tokens (the two
#: data shards hold unequal counts), at (h2)'s gates; decode at batch 2
#: on (1, 2) with the KV sequence cut in two, DEC_STEPS steps after a
#: DEC_PROMPT-token prefill, float32 logits within DEC_TOL_F32 of the
#: largest |logit|, bf16 within BF16_LOGIT_SHARE.  AdamW's early steps
#: move a weight whose gradient is near eps by up to lr for a rounding
#: of that gradient; at a learning rate of 1e-3 the data-parallel sums
#: left the parameters 1.6e-4 from world 1's, so (h6) trains at the
#: reference's default 3e-4
DP_STEPS, DP_SEED, DP_LR, DEC_PROMPT, DEC_STEPS = 5, 22, 3e-4, 64, 16
DEC_TOL_F32, BF16_LOGIT_SHARE = 1e-5, 0.02
#: (h7) tensor-parallel serving on (1, 2): a TP_PROMPT-token prefill and
#: TP_STEPS decode steps at batch 2, weights drawn from TP_SEED, float32
#: at (h6)'s decode gate.  bf16 at a fixed share of the largest |logit|
#: an arch: BF16_LOGIT_SHARE for smollm-135m; for mamba2-370m's 48
#: blocks BF16_DEEP_SHARE, since every bf16 path of it (card kernels, the
#: SSD's plain version on the card, the CPU, two TP ranks) lies 4.3e-2 to
#: 6.6e-2 from the float32 witness from the prefill on, not growing over
#: the decode steps, and 3.5e-2 to 4.9e-2 from the others
#: (``repro_torch.tools.bf16_drift``, NVIDIA H100 80GB HBM3, 700.00 W;
#: PERF.md section 6).  TP_STEPS cut from 16 to 8: (h7) took 111.8 s
#: inside the whole script and 62.6 s alone (same card; PERF.md section
#: 5), above the minute it is kept to, most of it gloo's collectives of
#: the decode steps
TP_PROMPT, TP_STEPS, TP_SEED = 64, 8, 23
BF16_DEEP_SHARE = 0.08
TP_BF16_SHARE = {"smollm-135m": BF16_LOGIT_SHARE,
                 "mamba2-370m": BF16_DEEP_SHARE}
TP_ARCHS = tuple(TP_BF16_SHARE)
#: (h8) tensor-parallel training on (1, 2) under the mesh's rules
#: (sequence parallel): TP_ARCHS at their published widths, TPT_STEPS
#: AdamW steps (h6's optimizer) of a TPT_BATCH x TPT_SEQ batch, weights
#: and batch drawn from TPT_SEED, against world 1 from the same weights
#: and batch.  float32 compute at the mesh's gates (losses MESH_TOL_H2,
#: parameters MESH_PARAM_TOL); bf16 compute (the published configs'):
#: the first step's loss and gradient, before clipping and AdamW, against
#: the float32 witness (the same weights in float32 at world 1), the TP
#: relative error at most TPT_WITNESS_FACTOR times world 1 bf16's own
#: plus TPT_WITNESS_SLACK, both fixed before any run
TPT_STEPS, TPT_BATCH, TPT_SEQ, TPT_SEED = 2, 2, 128, 24
TPT_WITNESS_FACTOR, TPT_WITNESS_SLACK = 2.0, 1e-4
#: (h2) bf16 losses of two ranks against (h1)'s: 2^-8 with a margin (the
#: final-parameter gate moved to (h8)'s float32 case: AdamW's first step
#: turns each flipped sign of a bf16 gradient into a whole step of the
#: learning rate)
MESH_TOL_H2_BF16 = 1e-2


def _mesh_dir() -> Path:
    return ROOT / "build" / "chip_smoke_mesh"


def _torchrun(nproc: int, args, ckpt_dir: Path):
    """``launch.train`` under ``torch.distributed.run`` (``nproc`` ranks on
    this host, all on card 0): (exit code, stdout, seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         "--device", "cuda", "--ckpt-dir", str(ckpt_dir), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
    return proc.returncode, proc.stdout, secs


def _ckpt_arrays(ckpt: Path, step: int) -> dict:
    import numpy as np
    with np.load(ckpt / f"step_{step}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _mesh_train(root: Path, card: str) -> None:
    """(h1) elastic at world 1 on NCCL vs --mesh none; (h2) two ranks on
    card 0 over gloo at model dim 2, then --resume at world 1."""
    import numpy as np
    common = ["--arch", "smollm-135m", "--steps", str(MESH_STEPS),
              *TRAIN_SHAPE, "--log-every", "1"]
    runs = {}
    for tag, extra in (("none", []), ("h1", ["--mesh", "elastic"])):
        rc, out, secs = _train(common + extra, root / tag)
        check(rc == 0, f"mesh {tag}: the launcher exited {rc}")
        runs[tag] = (_train_log(out)["summary"], secs)
    (none, _), (h1, h1_s) = runs["none"], runs["h1"]
    check(h1["mesh"] == {"data": 1, "model": 1}, f"h1 mesh {h1['mesh']}")
    rel = _rel(h1["losses"], none["losses"])
    check(len(h1["losses"]) == MESH_STEPS and rel <= MESH_TOL_H1,
          f"h1 losses {h1['losses']} vs {none['losses']}")
    print(f"[mesh h1] launch.train --mesh elastic, world 1 on NCCL, "
          f"smollm-135m published, {MESH_STEPS} steps of 8 x 128: losses "
          f"{h1['losses']} vs --mesh none {none['losses']}: max relative "
          f"difference {rel!r} (tol {MESH_TOL_H1}); bit-equal "
          f"{h1['losses'] == none['losses']}; "
          f"{1e3 * sum(h1['step_s'][1:]) / (MESH_STEPS - 1):.1f} ms a step "
          f"(--mesh none {1e3 * sum(none['step_s'][1:]) / (MESH_STEPS - 1):.1f}"
          f"); peak memory {h1['peak_memory_bytes']} bytes; {h1_s:.1f} s "
          f"with the process start ({card})")

    rc, out, secs = _torchrun(2, common + ["--mesh", "elastic",
                                           "--model-dim", "2",
                                           "--backend", "gloo"], root / "h2")
    check(rc == 0, f"h2: torch.distributed.run exited {rc}")
    h2 = _train_log(out)["summary"]
    peak1 = [int(ln.split()[-1]) for ln in out.splitlines()
             if ln.startswith("[train] rank 1 peak_memory_bytes")]
    check(h2["mesh"] == {"data": 1, "model": 2} and len(peak1) == 1,
          f"h2 mesh {h2['mesh']}, rank-1 lines {peak1}")
    rel2 = _rel(h2["losses"], h1["losses"])
    check(rel2 <= MESH_TOL_H2_BF16, f"h2 losses {h2['losses']} vs h1 "
                                    f"{h1['losses']}")
    a, b = (_ckpt_arrays(root / t, MESH_STEPS) for t in ("h2", "h1"))
    worst = max(float(np.abs(a[k].astype(np.float64) -
                             b[k].astype(np.float64)).max())
                for k in b if k.startswith("params::"))
    step_ms = 1e3 * sum(h2["step_s"][1:]) / (MESH_STEPS - 1)
    print(f"[mesh h2] two ranks on card 0 over gloo, (1, 2) mesh, "
          f"tensor-parallel bf16 blocks (no rules, as the launcher): losses "
          f"{h2['losses']}, max relative difference to h1 {rel2!r} (tol "
          f"{MESH_TOL_H2_BF16}); bit-equal {h2['losses'] == h1['losses']}; "
          f"final params max |h2 - h1| {worst!r} (not gated: (h8) holds "
          f"float32 to {MESH_PARAM_TOL}); "
          f"{step_ms:.1f} ms a step; peak memory a rank "
          f"[{h2['peak_memory_bytes']}, {peak1[0]}] bytes; {secs:.1f} s "
          f"with the processes' start ({card})")
    saved = _ckpt_arrays(root / "h2", MESH_STEPS)
    rc, out, secs = _train(["--arch", "smollm-135m", "--steps",
                            str(MESH_STEPS), *TRAIN_SHAPE, "--mesh",
                            "elastic", "--model-dim", "1", "--resume"],
                           root / "h2")
    check(rc == 0 and f"[train] resumed from step {MESH_STEPS}" in out,
          f"h2 resume exited {rc}")
    again = _ckpt_arrays(root / "h2", MESH_STEPS)
    check(sorted(again) == sorted(saved), "h2 resume: other leaves")
    for k, arr in saved.items():
        check(arr.dtype == again[k].dtype and
              arr.tobytes() == again[k].tobytes(),
              f"h2 resume: leaf {k} differs")
    print(f"[mesh h2] --resume at world 1, model dim 1 (NCCL) from the "
          f"two-rank checkpoint: {len(saved)} leaves restored onto the new "
          f"mesh and saved again, equal byte for byte; {secs:.1f} s "
          f"({card})")


def _h3_world(rank, world, out_dir, numel, device):
    """(h3) ``compressed_psum`` of seeded draws on ``device``: rank 0
    writes the result's digest, its error against the float all-reduce,
    the global absmax and the seconds of each."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    gen = torch.Generator().manual_seed(COMP_SEED + rank)
    x = torch.randn(numel, generator=gen).to(device)

    def timed(fn):
        dist.barrier()
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if x.is_cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    out, comp_s = timed(lambda: compressed_psum(x))
    ref = x.clone()
    _, float_s = timed(lambda: dist.all_reduce(ref))
    err = (out - ref).abs().max()
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    if rank == 0:
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        (Path(out_dir) / f"h3_{device}.json").write_text(json.dumps({
            "sha256": digest, "err": float(err), "absmax": float(amax),
            "comp_s": comp_s, "float_s": float_s}))


def _mesh_psum(root: Path, card: str) -> None:
    """(h3) the int8 all-reduce over smollm-135m's gradient size on two
    ranks of card 0 over gloo, and on two CPU ranks: the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import wire_bytes
    from repro_torch.launch.mesh import run_world
    numel = get_config("smollm-135m").param_count()
    t0 = time.perf_counter()
    for device, backend in (("cuda", "gloo"), ("cpu", "gloo")):
        run_world(_h3_world, 2, root / f"h3_{device}.store",
                  args=(str(root), numel, device), device=device,
                  backend=backend, timeout=600)
    secs = time.perf_counter() - t0
    cuda, cpu = (json.loads((root / f"h3_{d}.json").read_text())
                 for d in ("cuda", "cpu"))
    bound = cuda["absmax"] / 127.0 * 2
    check(cuda["err"] <= bound * 1.05,
          f"h3: |compressed - float| {cuda['err']} > bound {bound}")
    check(cuda["sha256"] == cpu["sha256"],
          "h3: the card's result differs from the CPU world's")
    w = wire_bytes(numel)
    nominal = w["int8_payload"] + w["scales"]
    print(f"[mesh h3] compressed_psum of {numel} float32 values (smollm-135m's "
          f"gradient size, seeded draws) on two ranks of card 0 over gloo: "
          f"max |int8 - float all-reduce| {cuda['err']!r} (bound "
          f"{bound * 1.05!r}); bit-equal to the 2-rank CPU gloo world "
          f"(sha256 {cuda['sha256'][:16]}); bytes sent {w['sent']} (the "
          f"int32 SUM buffer {w['int32_buffer']} + scales {w['scales']}) vs "
          f"{w['float32']} float32 bytes ({w['sent'] / w['float32']:.4f}x); "
          f"nominal int8 payload {nominal} ({w['float32'] / nominal:.2f}x "
          f"fewer, not what the collective carries); {cuda['comp_s']:.3f} s "
          f"vs float all-reduce {cuda['float_s']:.3f} s "
          f"({cuda['comp_s'] / cuda['float_s']:.2f}x slower; CPU world "
          f"{cpu['comp_s']:.3f} s); both worlds {secs:.1f} s ({card})")


def _moe_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("granite-moe-3b-a800m"), n_layers=MOE_LAYERS,
        moe_mode="dispatch", capacity_factor=MOE_CAP, dtype="float32",
        remat="none", seq_parallel=True)


def _moe_loss(mesh=None):
    """(loss, global grad norm, seconds, whether expert parallelism ran)
    of (h4)'s config, its weights drawn on card 0 from ``MOE_SEED``."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import get_model, init_params
    from repro_torch.models import layers
    from repro_torch.optim import global_norm, loss_and_grads
    cfg = _moe_cfg()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(MOE_SEED),
                         "cuda")
    batch = to_device(SyntheticLMData(DataConfig(
        batch=MOE_BATCH, seq=MOE_SEQ, vocab=256), cfg).batch_at(0), "cuda")
    rules = None
    if mesh is not None:
        params = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params, cfg.tie_embeddings))
        rules = sh.MeshRules(mesh, ("data",))
    ep = []
    inner = layers._moe_shardmap

    def recorded(*a, **k):
        out = inner(*a, **k)
        ep.append(out is not None)
        return out
    layers._moe_shardmap = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sh.activation_rules(rules):
            (loss, _), grads = loss_and_grads(get_model(cfg), params, batch)
        gn = global_norm(grads)
        torch.cuda.synchronize()
    finally:
        layers._moe_shardmap = inner
    return float(loss), float(gn), time.perf_counter() - t0, ep


def _h4_world(rank, world, out_dir):
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, world), ("data", "model"))
    loss, gn, secs, ep = _moe_loss(mesh)
    if rank == 0:
        (Path(out_dir) / "h4.json").write_text(json.dumps({
            "loss": loss, "gnorm": gn, "secs": secs, "ep": ep,
            "peak": torch.cuda.max_memory_allocated()}))


def _mesh_moe(root: Path, card: str) -> None:
    """(h4) MoE expert parallelism on (1, 2) over gloo on card 0 against
    the world-1 dispatch path in this process."""
    import math
    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    run_world(_h4_world, 2, root / "h4.store", args=(str(root),),
              device="cuda", backend="gloo", timeout=600)
    world_s = time.perf_counter() - t0
    got = json.loads((root / "h4.json").read_text())
    loss, gn, secs, ep = _moe_loss()
    check(got["ep"] == [True] * MOE_LAYERS and not any(ep),
          f"h4: expert parallelism ran {got['ep']} on the mesh, {ep} alone")
    check(math.isfinite(got["gnorm"]) and got["gnorm"] > 0,
          f"h4: gradient norm {got['gnorm']}")
    rel = abs(got["loss"] - loss) / abs(loss)
    check(rel <= MOE_TOL, f"h4: loss {got['loss']} vs {loss}")
    rel_g = abs(got["gnorm"] - gn) / gn
    check(rel_g <= MOE_TOL, f"h4: gradient norm {got['gnorm']} vs {gn}")
    cfg = _moe_cfg()
    print(f"[mesh h4] granite-moe-3b-a800m widths (d {cfg.d_model}, "
          f"{cfg.n_experts} experts padded to {cfg.n_experts_padded}, top-"
          f"{cfg.topk}), {MOE_LAYERS} of 32 layers, float32, {MOE_BATCH} x "
          f"{MOE_SEQ} tokens, capacity {MOE_CAP}: expert-parallel loss on "
          f"(1, 2) over gloo {got['loss']!r} vs world-1 dispatch {loss!r}, "
          f"relative {rel!r} (tol {MOE_TOL}); gradient norm {got['gnorm']!r}"
          f" vs {gn!r}, relative {rel_g!r} (tol {MOE_TOL}); loss and "
          f"backward {got['secs']:.3f} s a rank (world 1 {secs:.3f} s); "
          f"peak memory rank 0 {got['peak']} bytes; "
          f"world {world_s:.1f} s with the processes' start ({card})")


def _h6_train(rank, mesh):
    """(h6) DP_STEPS data-parallel ZeRO-1 steps on ``mesh`` and, on rank 0,
    the world-1 steps from the same weights and batches: the numbers
    (h6) prints and checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import OptConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    model, ocfg = get_model(cfg), OptConfig(lr=DP_LR, warmup_steps=2,
                                            total_steps=50)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(DP_SEED),
                         "cuda")
    data = SyntheticLMData(DataConfig(batch=8, seq=128, vocab=cfg.vocab),
                           cfg)
    keep = 128 - 12 * torch.arange(8, device="cuda")[:, None]

    def batch_at(i):
        b = to_device(data.batch_at(i), "cuda")
        b["mask"] = (torch.arange(128, device="cuda")[None] < keep).float()
        return b
    state = init_train_state(params, ocfg)
    state = S.lay_out(state, mesh, S.state_shardings(mesh, cfg, state))
    mv = sum(sh.local(x).numel() * 4 for k in ("m", "v")
             for x in tree_leaves(state[k]))
    step = make_train_step(model, ocfg)
    losses, tokens, step_s = [], [], []
    for i in range(DP_STEPS):
        b = batch_at(i)
        b = S.lay_out(b, mesh, S.batch_shardings(mesh, cfg, b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        step_s.append(time.perf_counter() - t0)
        tokens.append(float(met["tokens"]))
    new = sh.unshard(state["params"])
    if rank != 0:
        return None
    one = init_train_state(params, ocfg)
    want = []
    for i in range(DP_STEPS):
        one, met = step(one, batch_at(i))
        want.append(float(met["loss"]))
    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(new), tree_leaves(one["params"])))
    close = all(torch.allclose(a, b, rtol=MESH_PARAM_TOL,
                               atol=MESH_PARAM_TOL)
                for a, b in zip(tree_leaves(new), tree_leaves(one["params"])))
    mv1 = sum(x.numel() * 4 for k in ("m", "v") for x in tree_leaves(one[k]))
    return {"losses": losses, "world1": want, "tokens": tokens,
            "want_tokens": float(keep.sum()),
            "rel": _rel(losses, want), "param_diff": worst,
            "params_close": close, "mv_bytes": mv, "mv_bytes_world1": mv1,
            "step_ms": 1e3 * float(np.mean(step_s[1:]))}


def _h6_decode(rank, mesh, dtype: str):
    """(h6) greedy decode of smollm-135m (``dtype`` compute) at batch 2:
    world 1 from a DEC_PROMPT-token prefill, then the same steps fed
    world 1's tokens with the cache's KV sequence cut over ``mesh``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype=dtype)
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(DP_SEED),
                         "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, DEC_PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(6))
    max_len = DEC_PROMPT + DEC_STEPS
    logits, cache = model.prefill(params, {"tokens": prompt}, max_len)
    sharded = {k: v if k == "len" else v.clone() for k, v in cache.items()}
    shape = ShapeConfig("h6", max_len, 2, "decode")
    sharded = S.lay_out(sharded, mesh, S.cache_shardings(mesh, cfg, sharded,
                                                         shape))
    tok = logits.argmax(-1)
    want, got, toks = [], [], []
    t_one = t_mesh = 0.0
    with torch.no_grad():
        for _ in range(DEC_STEPS):
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, tok)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            glg, sharded = model.decode_step(
                params, sharded, S.lay_out(tok, mesh,
                                           S.token_shardings(mesh, shape)))
            glg = sh.full(glg)
            torch.cuda.synchronize()
            t_one += t1 - t0
            t_mesh += time.perf_counter() - t1
            want.append(lg.float())
            got.append(glg.float())
            tok = lg.argmax(-1)
    want, got = torch.stack(want), torch.stack(got)
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > err
    same = got.argmax(-1) == want.argmax(-1)
    return {"dtype": dtype, "share": err / float(want.abs().max()),
            "tokens_equal": bool(same.all()),
            "clear_equal": bool(same[clear].all()),
            "clear": int(clear.sum()), "n": int(clear.numel()),
            "ms_world1": 1e3 * t_one / DEC_STEPS,
            "ms_mesh": 1e3 * t_mesh / DEC_STEPS}


def _h6_world(rank, world, out_dir):
    from repro_torch.launch.mesh import make_mesh
    res = {"train": _h6_train(rank, make_mesh((2, 1), ("data", "model")))}
    mesh = make_mesh((1, 2), ("data", "model"))
    res["decode"] = [_h6_decode(rank, mesh, dt)
                     for dt in ("float32", "bfloat16")]
    if rank == 0:
        (Path(out_dir) / "h6.json").write_text(json.dumps(res))


def _mesh_data_axes(root: Path, card: str) -> None:
    """(h6) the data axes on two ranks of card 0 over gloo: the data-
    parallel ZeRO-1 step and the sequence-sharded decode against world
    1."""
    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    run_world(_h6_world, 2, root / "h6.store", args=(str(root),),
              device="cuda", backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    res = json.loads((root / "h6.json").read_text())
    tr = res["train"]
    check(tr["rel"] <= MESH_TOL_H2 and tr["params_close"] and
          tr["tokens"] == [tr["want_tokens"]] * DP_STEPS,
          f"h6 train: losses {tr['losses']} vs world 1 {tr['world1']}, "
          f"params max |diff| {tr['param_diff']}, tokens {tr['tokens']}")
    check(2 * tr["mv_bytes"] == tr["mv_bytes_world1"],
          f"h6 train: m/v bytes a rank {tr['mv_bytes']} vs world 1 "
          f"{tr['mv_bytes_world1']}")
    print(f"[mesh h6] data-parallel ZeRO-1 step, smollm-135m published "
          f"float32, (2, 1) mesh over gloo on card 0, {DP_STEPS} steps of "
          f"8 x 128 (unequal masks, {tr['want_tokens']:.0f} tokens): losses "
          f"{tr['losses']} vs world 1 {tr['world1']}: max relative "
          f"difference {tr['rel']!r} (tol {MESH_TOL_H2}); final params max "
          f"|diff| {tr['param_diff']!r} (tol {MESH_PARAM_TOL}); m + v "
          f"{tr['mv_bytes']} bytes a rank vs {tr['mv_bytes_world1']} at "
          f"world 1; {tr['step_ms']:.1f} ms a step ({card})")
    for d in res["decode"]:
        if d["dtype"] == "float32":
            ok = d["share"] <= DEC_TOL_F32 and d["tokens_equal"]
            gate = f"tol {DEC_TOL_F32}, tokens equal {d['tokens_equal']}"
        else:
            ok = d["share"] <= BF16_LOGIT_SHARE and d["clear_equal"]
            gate = (f"tol {BF16_LOGIT_SHARE}, argmax equal at the "
                    f"{d['clear']} of {d['n']} rows whose top-two gap "
                    f"exceeds the error: {d['clear_equal']}")
        check(ok, f"h6 decode {d}")
        print(f"[mesh h6] sequence-sharded decode, smollm-135m published "
              f"{d['dtype']}, batch 2, (1, 2) mesh, KV sequence "
              f"{DEC_PROMPT + DEC_STEPS} cut in two, {DEC_STEPS} steps after "
              f"a {DEC_PROMPT}-token prefill: logits within "
              f"{d['share']!r} of the largest |logit| of world 1's ({gate}); "
              f"{d['ms_mesh']:.2f} ms a step on the mesh, "
              f"{d['ms_world1']:.2f} ms at world 1 ({card})")
    print(f"[mesh h6] {secs:.1f} s with the processes' start ({card})")


def _h7_serve(arch: str, dtype: str, mesh=None, toks=None):
    """(h7) ``arch``'s published config (``dtype`` float32: float32
    compute; bfloat16: bf16 weights and compute; witness: bf16 weights,
    float32 compute) at batch 2, its weights and prompt drawn on the
    card: the prefill and TP_STEPS decode steps, greedy (``toks`` None)
    or fed ``toks``, with tensor-parallel blocks on ``mesh`` (world 1
    when None); the logits, the tokens fed, the parameter bytes this
    rank holds, its peak memory above what was allocated before, the
    seconds of the prefill and decode, and the kernels' launches (their
    counts set to 0 just before the prefill and read after the last
    step)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32") if dtype == "float32" \
        else dataclasses.replace(cfg, param_dtype="bfloat16")
    if dtype == "witness":
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(TP_SEED),
                         "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, TP_PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               TP_SEED + 1))
    shape = ShapeConfig("h7", TP_PROMPT + TP_STEPS, 2, "decode")
    rules = None
    if mesh is not None:
        params = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params, cfg.tie_embeddings))
        rules = S.make_rules(mesh, cfg)
    pbytes = sum(sh.local(x).numel() * sh.local(x).element_size()
                 for x in tree_leaves(params))
    kw = {} if cfg.family == "ssm" else {"max_len": TP_PROMPT + TP_STEPS}
    logits, fed = [], []
    fa.reset_launches()
    ssd.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad(), sh.activation_rules(rules):
        lg, cache = model.prefill(params, {"tokens": prompt}, **kw)
        if mesh is not None:
            cache = S.lay_out(cache, mesh, S.cache_shardings(mesh, cfg,
                                                             cache, shape))
        for i in range(TP_STEPS):
            logits.append(lg.float())
            tok = lg.argmax(-1) if toks is None else toks[i]
            fed.append(tok)
            if mesh is not None:
                tok = S.lay_out(tok, mesh, S.token_shardings(mesh, shape))
            lg, cache = model.decode_step(params, cache, tok)
            lg = sh.full(lg)
        logits.append(lg.float())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    logits = torch.stack(logits)
    launches = {**fa.LAUNCHES, **ssd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() - base
    return logits, fed, pbytes, peak, secs, launches


def _h7_world(rank, world, out_dir):
    """(h7) on both ranks: world 1 (every rank computes it, only rank 0
    keeps it), then the tensor-parallel run fed world 1's tokens; for
    bf16 weights rank 0 also computes the float32 witness."""
    import gc
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"))
    res = []
    for arch in TP_ARCHS:
        for dtype in ("float32", "bfloat16"):
            want, toks, pb1, peak1, s1, _ = _h7_serve(arch, dtype)
            gc.collect()
            torch.cuda.empty_cache()
            got, _, pb2, peak2, s2, launches = _h7_serve(arch, dtype, mesh,
                                                         toks)
            gc.collect()
            torch.cuda.empty_cache()
            err = float((got - want).abs().max())
            top2 = want.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > err
            same = got.argmax(-1) == want.argmax(-1)
            witness = {}
            if dtype == "bfloat16" and rank == 0:
                f32 = _h7_serve(arch, "witness", toks=toks)[0]
                top = float(f32.abs().max())
                witness = {"world1": float((want - f32).abs().max()) / top,
                           "mesh": float((got - f32).abs().max()) / top}
            res.append({"arch": arch, "dtype": dtype,
                        "share": err / float(want.abs().max()),
                        "steps": [float((g - w).abs().max()) /
                                  float(want.abs().max())
                                  for g, w in zip(got, want)],
                        "witness": witness,
                        "tokens_equal": bool(same.all()),
                        "clear_equal": bool(same[clear].all()),
                        "clear": int(clear.sum()), "n": int(clear.numel()),
                        "param_bytes": pb2, "param_bytes_world1": pb1,
                        "peak": peak2, "peak_world1": peak1,
                        "s": s2, "s_world1": s1, "launches": launches})
    if rank == 0:
        (Path(out_dir) / "h7.json").write_text(json.dumps(res))


def _mesh_tp(root: Path, card: str) -> None:
    """(h7) tensor-parallel serving on two ranks of card 0 over gloo
    against world 1."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    run_world(_h7_world, 2, root / "h7.store", args=(str(root),),
              device="cuda", backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    for d in json.loads((root / "h7.json").read_text()):
        if d["dtype"] == "float32":
            ok = d["share"] <= DEC_TOL_F32 and d["tokens_equal"]
            gate = f"tol {DEC_TOL_F32}, tokens equal {d['tokens_equal']}"
        else:
            limit, w = TP_BF16_SHARE[d["arch"]], d["witness"]
            ok = d["share"] <= limit and d["clear_equal"] and \
                max(w.values()) <= limit
            gate = (f"tol {limit}, argmax equal at the {d['clear']} of "
                    f"{d['n']} rows whose top-two gap exceeds the error: "
                    f"{d['clear_equal']}; the prefill's share "
                    f"{d['steps'][0]!r}, the decode steps' largest "
                    f"{max(d['steps'][1:])!r}; from the float32 witness: "
                    f"world 1 {w['world1']!r}, the mesh {w['mesh']!r}, "
                    f"tol {limit}")
        check(ok, f"h7 {d}")
        # the path went through the kernels: one flash launch a layer's
        # prefill attention (smollm-135m), one SSD call a Mamba block's
        # (mamba2-370m), on each rank; decode reaches neither
        cfg = get_config(d["arch"])
        want = ({"flash_attention": cfg.n_layers, "ssd_scan": 0}
                if cfg.family == "dense" else
                {"flash_attention": 0, "ssd_scan": cfg.n_layers})
        check(d["launches"] == want, f"h7 {d['arch']} launches "
              f"{d['launches']}, expected {want}")
        print(f"[mesh h7] tensor-parallel serving, {d['arch']} published, "
              f"{d['dtype']} weights{' and compute' if d['dtype'] == 'float32' else ''}, batch 2, "
              f"(1, 2) mesh over gloo on card 0, a {TP_PROMPT}-token "
              f"prefill and {TP_STEPS} decode steps: logits within "
              f"{d['share']!r} of the largest |logit| of world 1's ({gate}); "
              f"parameters {d['param_bytes']} bytes a rank vs "
              f"{d['param_bytes_world1']} at world 1; peak memory "
              f"{d['peak'] / 1e9:.3f} GB a rank vs "
              f"{d['peak_world1'] / 1e9:.3f} GB; prefill + decode "
              f"{d['s']:.2f} s vs {d['s_world1']:.2f} s at world 1; kernel "
              f"launches a rank (counts set to 0 before the prefill) "
              f"{json.dumps(d['launches'])} ({card})")
    print(f"[mesh h7] {secs:.1f} s with the processes' start ({card})")


def _h8_batch(cfg):
    """(h8)'s batch: TPT_BATCH rows of TPT_SEQ next-token pairs drawn on
    the card from TPT_SEED + 1."""
    import torch
    toks = torch.randint(0, cfg.vocab, (TPT_BATCH, TPT_SEQ + 1),
                         device="cuda", generator=torch.Generator(
                             "cuda").manual_seed(TPT_SEED + 1))
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def _h8_train(arch: str, dtype: str, steps: int, mesh=None):
    """(h8) ``arch``'s published config (``dtype`` float32: float32
    compute; bfloat16: as published) from weights drawn on the card from
    TPT_SEED: the first step's loss and gradient (full, before clipping),
    then ``steps`` AdamW steps, tensor-parallel on ``mesh`` under its
    rules (world 1 when None).  Returns the numbers and, on rank 0, the
    full first gradient and final parameters."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import (OptConfig, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    model, ocfg = get_model(cfg), OptConfig(lr=DP_LR, warmup_steps=2,
                                            total_steps=50)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(TPT_SEED),
                         "cuda")
    batch = _h8_batch(cfg)
    state = init_train_state(params, ocfg)
    rules = None
    if mesh is not None:
        state = S.lay_out(state, mesh, S.state_shardings(mesh, cfg, state))
        rules = S.make_rules(mesh, cfg)
    pbytes = sum(sh.local(x).numel() * sh.local(x).element_size()
                 for x in tree_leaves(state["params"]))
    step = make_train_step(model, ocfg)
    losses, norms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sh.activation_rules(rules):
        (loss0, _), grads = loss_and_grads(model, state["params"], batch)
        grads = [g.double() for g in tree_leaves(sh.unshard(grads))]
        for _ in range(steps):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        final = [p.double() for p in tree_leaves(sh.unshard(state["params"]))]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"loss0": float(loss0), "losses": losses, "grad_norm": norms,
            "param_bytes": pbytes, "secs": secs,
            "peak": torch.cuda.max_memory_allocated() - base}, grads, final


def _h8_world(rank, world, out_dir):
    """(h8) on both ranks: the tensor-parallel runs; on rank 0 also world
    1 (before each, so that rank 1 waits at the first collective).  Each
    rank writes its parameter bytes and peak memory a run; rank 0 the
    comparisons."""
    import gc
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"))
    res, mine = [], {}

    def rel(got, want) -> float:
        num = sum(float((g - w).square().sum()) for g, w in zip(got, want))
        den = sum(float(w.square().sum()) for w in want)
        return (num / den) ** 0.5

    for arch in TP_ARCHS:
        out = {"arch": arch}
        for dtype, steps in (("float32", TPT_STEPS), ("bfloat16", 0)):
            if rank == 0:
                one, g1, p1 = _h8_train(arch, dtype, steps)
                gc.collect()
                torch.cuda.empty_cache()
            got, g2, p2 = _h8_train(arch, dtype, steps, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            mine[f"{arch} {dtype}"] = [got["param_bytes"], got["peak"]]
            if rank != 0:
                continue
            if dtype == "float32":
                witness = (one["loss0"], g1)
                out["float32"] = {
                    "tp": got, "world1": one,
                    "loss_rel": _rel(got["losses"], one["losses"]),
                    "param_diff": max(float((a - b).abs().max())
                                      for a, b in zip(p2, p1)),
                    "params_close": all(torch.allclose(
                        a, b, rtol=MESH_PARAM_TOL, atol=MESH_PARAM_TOL)
                        for a, b in zip(p2, p1)),
                    "grad_rel_world1": rel(g2, g1)}
            else:
                lw, gw = witness
                out["bfloat16"] = {
                    "tp": got, "world1": one,
                    "loss_err": abs(got["loss0"] - lw) / abs(lw),
                    "loss_err_world1": abs(one["loss0"] - lw) / abs(lw),
                    "grad_err": rel(g2, gw), "grad_err_world1": rel(g1, gw)}
            del g2, p2
            if rank == 0:
                del g1, p1
        res.append(out)
    (Path(out_dir) / f"h8_rank{rank}.json").write_text(json.dumps(mine))
    if rank == 0:
        (Path(out_dir) / "h8.json").write_text(json.dumps(res))


def _mesh_tp_train(root: Path, card: str) -> None:
    """(h8) tensor-parallel training on two ranks of card 0 over gloo
    against world 1 and, for bf16, against the float32 witness."""
    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    run_world(_h8_world, 2, root / "h8.store", args=(str(root),),
              device="cuda", backend="gloo", timeout=600)
    secs = time.perf_counter() - t0
    ranks = [json.loads((root / f"h8_rank{r}.json").read_text())
             for r in range(2)]
    for d in json.loads((root / "h8.json").read_text()):
        f, b = d["float32"], d["bfloat16"]
        pb, peak = ({dt: [r[f"{d['arch']} {dt}"][i] for r in ranks]
                     for dt in ("float32", "bfloat16")} for i in (0, 1))
        check(f["loss_rel"] <= MESH_TOL_H2 and f["params_close"],
              f"h8 {d['arch']} float32: losses {f['tp']['losses']} vs "
              f"world 1 {f['world1']['losses']}, params max |diff| "
              f"{f['param_diff']}")
        loss_lim = TPT_WITNESS_FACTOR * b["loss_err_world1"] + \
            TPT_WITNESS_SLACK
        grad_lim = TPT_WITNESS_FACTOR * b["grad_err_world1"] + \
            TPT_WITNESS_SLACK
        check(b["loss_err"] <= loss_lim and b["grad_err"] <= grad_lim,
              f"h8 {d['arch']} bf16 against the float32 witness: {b}")
        print(f"[mesh h8] tensor-parallel training, {d['arch']} published, "
              f"float32 compute, (1, 2) mesh under its rules (sequence "
              f"parallel) over gloo on card 0, {TPT_STEPS} AdamW steps of "
              f"{TPT_BATCH} x {TPT_SEQ}: losses {f['tp']['losses']} vs world "
              f"1 {f['world1']['losses']}, max relative difference "
              f"{f['loss_rel']!r} (tol {MESH_TOL_H2}); final params max "
              f"|diff| {f['param_diff']!r} (tol {MESH_PARAM_TOL}); grad norm "
              f"{f['tp']['grad_norm']} vs world 1 {f['world1']['grad_norm']};"
              f" first gradient relative to world 1's "
              f"{f['grad_rel_world1']!r}; parameters {pb['float32']} bytes "
              f"on ranks 0 and 1 vs {f['world1']['param_bytes']} at world 1;"
              f" peak memory {[round(x / 1e9, 3) for x in peak['float32']]} "
              f"GB vs {f['world1']['peak'] / 1e9:.3f} GB; first backward and the "
              f"steps {f['tp']['secs']:.2f} s vs {f['world1']['secs']:.2f} s "
              f"({card})")
        print(f"[mesh h8] tensor-parallel training, {d['arch']} published "
              f"bf16, the first step's loss and gradient before clipping "
              f"against the float32 witness (the same weights in float32 at "
              f"world 1): loss relative error TP {b['loss_err']!r}, world 1 "
              f"{b['loss_err_world1']!r} (limit {loss_lim!r}); gradient "
              f"relative error TP {b['grad_err']!r}, world 1 "
              f"{b['grad_err_world1']!r} (limit {grad_lim!r}; "
              f"{TPT_WITNESS_FACTOR} x world 1 + {TPT_WITNESS_SLACK}); "
              f"parameters {pb['bfloat16']} bytes on ranks 0 and 1 vs "
              f"{b['world1']['param_bytes']} at world 1; peak memory "
              f"{[round(x / 1e9, 3) for x in peak['bfloat16']]} GB vs "
              f"{b['world1']['peak'] / 1e9:.3f} GB ({card})")
    RUN["h8_s"] = secs
    print(f"[mesh h8] {secs:.1f} s with the processes' start ({card})")


def _grid_fields(grid) -> dict:
    return {key: {p: (dataclasses.asdict(r), r.to_dict())
                  for p, r in cell.items()} for key, cell in grid.items()}


def _h5_world(rank, world, out_dir):
    """(h5) (a)'s DS_PGM grid and (b)'s exhaustive grid on the sweep
    mesh; each rank writes its results and its subset-DP launches."""
    import pickle

    import torch
    from repro_torch.cachesim import SimConfig, get_trace, run_grid
    from repro_torch.core import batched
    from repro_torch.kernels.subsetdp import ops
    from repro_torch.launch.mesh import make_sweep_mesh
    mesh = make_sweep_mesh()
    trace = get_trace("gradle", N_REQUESTS, seed=0)
    calls = []
    inner = batched._cells_sharded

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    batched._cells_sharded = counted
    out = {"mesh": tuple(mesh.shape)}
    for tag, cfg, pol in (
            ("a", SimConfig(n_caches=3, costs=(1.0, 2.0, 3.0),
                            alg="ds_pgm", **PAPER), ("pi", "fno", "fna")),
            ("e", SimConfig(n_caches=8, costs=(1.0, 2.0, 3.0, 1.5) * 2,
                            alg="exhaustive", **PAPER), ("fno", "fna", "pi"))):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = run_grid({"gradle": trace}, cfg, "miss_penalty",
                        GRID_PENALTIES, policies=pol, device="cuda",
                        mesh=mesh)
        torch.cuda.synchronize()
        out[tag] = {"secs": time.perf_counter() - t0,
                    "launches": ops.LAUNCHES["subset_argmin"],
                    "sharded": len(calls), "grid": _grid_fields(grid)}
        calls.clear()
    (Path(out_dir) / f"h5_{rank}.pkl").write_bytes(pickle.dumps(out))


def _mesh_grid(root: Path, grid_e, launches_e: int, dev, card: str) -> None:
    """(h5) the sweep mesh on two ranks of card 0 over gloo, held field
    for field to ``mesh=None`` on one rank (this process; (e)'s from
    phase 6's cold grid)."""
    import pickle
    from repro_torch.cachesim import SimConfig, get_trace, run_grid
    from repro_torch.kernels.subsetdp import ops
    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    run_world(_h5_world, 2, root / "h5.store", args=(str(root),),
              device="cuda", backend="gloo", timeout=600)
    world_s = time.perf_counter() - t0
    trace = get_trace("gradle", N_REQUESTS, seed=0)
    cfg_a = SimConfig(n_caches=3, costs=(1.0, 2.0, 3.0), alg="ds_pgm",
                      **PAPER)
    ops.reset_launches()
    t0 = time.perf_counter()
    grid_a = run_grid({"gradle": trace}, cfg_a, "miss_penalty",
                      GRID_PENALTIES, policies=("pi", "fno", "fna"),
                      device=dev)
    sync()
    alone_s = time.perf_counter() - t0
    launches_a = ops.LAUNCHES["subset_argmin"]
    want = {"a": (_grid_fields(grid_a), launches_a),
            "e": (_grid_fields(grid_e), launches_e)}
    for rank in range(2):
        got = pickle.loads((root / f"h5_{rank}.pkl").read_bytes())
        check(got["mesh"] == (2,), f"h5 rank {rank}: mesh {got['mesh']}")
        for tag, (fields, launches) in want.items():
            check(got[tag]["grid"] == fields,
                  f"h5 rank {rank} ({tag}): results != mesh=None")
            check(got[tag]["launches"] == launches,
                  f"h5 rank {rank} ({tag}): subset_argmin launches "
                  f"{got[tag]['launches']}, mesh=None {launches}")
        check(got["a"]["sharded"] >= 1,
              f"h5 rank {rank}: the DS_PGM build was not sharded")
        print(f"[mesh h5] rank {rank} of the (2,) cells mesh over gloo: "
              f"(a) n=3 DS_PGM grid {got['a']['secs']:.3f} s, its stacked "
              f"build sharded ({got['a']['sharded']} call), subset_argmin "
              f"launches {got['a']['launches']}; (e) n=8 exhaustive grid "
              f"{got['e']['secs']:.3f} s, unsharded, subset_argmin launches "
              f"{got['e']['launches']} (mesh=None: {launches_e}); both "
              f"grids equal mesh=None field for field ({card})")
    print(f"[mesh h5] miss_penalty {GRID_PENALTIES}, {N_REQUESTS} gradle "
          f"requests: (a) on one rank without a mesh {alone_s:.3f} s; the "
          f"two-rank world {world_s:.1f} s with the processes' start "
          f"({card})")


def phase_mesh(dev, grid_e, launches_e: int, card: str) -> None:
    """Phase 10: the device mesh — the launcher on meshes (h1, h2), the
    int8 all-reduce (h3), MoE expert parallelism (h4), the sweep mesh
    (h5), the data-parallel ZeRO-1 step and the sequence-sharded decode
    (h6), tensor-parallel serving (h7) and training (h8)."""
    import shutil
    root = _mesh_dir()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        _mesh_train(root, card)
        _mesh_psum(root, card)
        _mesh_moe(root, card)
        _mesh_grid(root, grid_e, launches_e, dev, card)
        _mesh_data_axes(root, card)
        _mesh_tp(root, card)
        _mesh_tp_train(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[mesh] phase 10: {time.perf_counter() - t0:.1f} s; carried "
          f"over gloo on card 0's tensors: all_reduce SUM float32 (h2's "
          f"norm, h3's float reference), MAX float32 and SUM int32 (h3), "
          f"all_gather_into_tensor (h2's parameter gathers and checkpoint, "
          f"h4's token blocks, h5's table rows, h6's ZeRO-1 parameter "
          f"slices; h7's and h8's column, sequence and logit gathers, "
          f"h8's backward of its reduce-scatters), "
          f"reduce_scatter_tensor (h6's gradients, h7's and h8's "
          f"sequence-parallel products, h8's backward of its sequence "
          f"gathers), all_reduce MAX float32 (h6's and h7's decode "
          f"maxima, h8's cross-entropy maxima), all_to_all_single (h4), "
          f"barrier; over NCCL at world 1 (h1, h2's resume) only "
          f"barrier: a one-rank mesh dim issues no gather or reduce "
          f"({card})")

# ---------------------------------------------------------------------------
# the dry run (phase 11)
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "artifacts" / "dryrun_torch"
#: the cells whose per-device step runs on the card against its meta trace
#: (single mesh): the flash and SSD prefills at 32k, a decode, and a train
#: cell the dry run predicts fits in 80 GB
DRYRUN_CHECKS = (("smollm-135m", "prefill_32k"), ("mamba2-370m", "prefill_32k"),
                 ("smollm-135m", "decode_32k"), ("smollm-135m", "train_4k"))
#: the trace's peak temporaries within this band of the caching
#: allocator's peak above the step's baseline
PEAK_BAND = (0.75, 1.25)
#: the kernels at the 32k prefill shapes: flash (b, s, hq, hkv, d), causal;
#: SSD (b, s, h, p, n, chunk); flash's plain version runs query blocks of
#: FLASH_LONG_BLOCK rows against the keys before them
FLASH_LONG = (2, 32768, 9, 3, 64)
SSD_LONG = (2, 32768, 32, 64, 128, 256)
FLASH_LONG_BLOCK = 2048


def start_dryrun_sweep():
    """Phase 11's sweep of the 64 cells on the meta device, started as a
    child process at once (it needs no card, only host time, and runs
    beside phases 2-10); its output goes to ``build/dryrun_sweep.log``."""
    import os
    log = ROOT / "build" / "dryrun_sweep.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--force", "--out", str(DRYRUN_DIR)],
            cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def _dryrun_records(sweep, card: str) -> dict:
    """Wait for the sweep; check and print its 64 records."""
    from repro_torch.configs import cells
    proc, log, t0 = sweep
    rc = proc.wait(timeout=900)
    secs = time.perf_counter() - t0
    tail = log.read_text()[-3000:]
    check(rc == 0, f"dry-run sweep exited {rc}:\n{tail}")
    recs = {}
    print(f"[dryrun] {card}; constants: bf16 989e12 FLOP/s, HBM 3.35e12 B/s, "
          f"collectives 400 Gb/s = 50 GB/s a GPU (NDR; the 16-wide model "
          f"axis spans two NVLink nodes of 8); sweep {secs:.1f} s as a child "
          f"process")
    from repro_torch.configs import get_config
    from repro_torch.launch.cost import COLLECTIVE_KINDS
    from repro_torch.launch.dryrun import DEPARTURES
    print("[dryrun] cell | chips | flops/dev | bytes/dev | collective "
          "bytes/dev (all-gather, all-reduce, reduce-scatter, all-to-all) "
          "| bottleneck | MFU at roofline | temp GB | step s (roofline)")
    for arch, shape in cells():
        for mesh, chips in (("single", 256), ("multi", 512)):
            path = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
            check(path.exists(), f"dry run wrote no {path.name}")
            rec = json.loads(path.read_text())
            rl, coll = rec["roofline"], rec["collectives"]
            check(rec["chips"] == chips and rl["chips"] == chips and
                  rec["trace_device"] == "meta" and
                  rl["flops_per_device"] > 0 and
                  rl["hbm_bytes_per_device"] > 0 and
                  rl["bottleneck"] in ("compute", "memory", "collective"),
                  f"dry run {path.name}: {rl}")
            # the data axes and the cache as the reference lays them out:
            # a train cell reduce-scatters its gradient, a prefill its
            # sequence-parallel products, a decode cell all-reduces its
            # softmax statistics, a MoE train or prefill cell exchanges
            # tokens with the expert shards
            kind = shape.split("_")[0]
            family = get_config(arch).family
            check(rec["departures"] == DEPARTURES and
                  list(coll) == list(COLLECTIVE_KINDS) and
                  (coll["reduce-scatter"] > 0) ==
                  (kind in ("train", "prefill")) and
                  (kind not in ("decode", "long") or family == "ssm" or
                   coll["all-reduce"] > 0) and
                  (coll["all-to-all"] > 0) ==
                  (family == "moe" and kind in ("train", "prefill")),
                  f"dry run {path.name}: departures {rec['departures']}, "
                  f"collectives {coll}")
            recs[(arch, shape, mesh)] = rec
            print(f"[dryrun] {arch} {shape} {mesh} | {chips} | "
                  f"{rl['flops_per_device']:.4e} | "
                  f"{rl['hbm_bytes_per_device']:.4e} | "
                  f"{rl['collective_bytes_per_device']:.4e} ("
                  f"{coll['all-gather']:.4e}, {coll['all-reduce']:.4e}, "
                  f"{coll['reduce-scatter']:.4e}, {coll['all-to-all']:.4e}) | "
                  f"{rl['bottleneck']} | {rl['mfu_at_roofline']:.4e} | "
                  f"{rec['memory_analysis']['temp_size_in_bytes'] / 1e9:.3f}"
                  f" | {rl['roofline_step_time_s']:.4e}")
    check(len(recs) == 64, f"{len(recs)} dry-run records, expected 64")
    return recs


def _dryrun_on_card(recs: dict, card: str) -> dict:
    """Each DRYRUN_CHECKS cell's per-device step on the card under the
    cost trace, against the sweep's meta trace: kernel calls equal to the
    launches of the traced step (the counters read around it), FLOPs
    equal, peak temporaries within PEAK_BAND of the allocator's; the
    counters set to 0 before the cell and read after it hold the traced
    and the timed step's launches, twice the trace's calls.  Returns those
    launches by kernel."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch import dryrun
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch, shape in DRYRUN_CHECKS:
        meta = recs[(arch, shape, "single")]
        fa.reset_launches()
        ssd.reset_launches()
        rec = dryrun.trace_cell(arch, shape, "single", device="cuda")
        total = {k: v for k, v in {**fa.LAUNCHES, **ssd.LAUNCHES}.items()
                 if v}
        got = rec["card"]["launches"]
        temp = meta["memory_analysis"]["temp_size_in_bytes"]
        peak = rec["card"]["peak_bytes"]
        ratio = temp / peak if peak else float("inf")
        flops = rec["roofline"]["flops_per_device"]
        want = meta["roofline"]["flops_per_device"]
        print(f"[dryrun card] {arch} {shape} single, per-device batch "
              f"{rec['per_device_batch']}: kernel launches of the traced "
              f"step {json.dumps(got)}, of it and the timed step "
              f"{json.dumps(total)} (meta trace "
              f"{json.dumps(meta['kernel_calls'])}); FLOPs card "
              f"{flops:.6e}, meta {want:.6e}; ops card {rec['ops']}, meta "
              f"{meta['ops']}; peak temporaries: trace {temp / 1e9:.3f} GB, "
              f"allocator {peak / 1e9:.3f} GB, ratio {ratio:.3f} (band "
              f"{PEAK_BAND}); step {rec['card']['step_s']:.4f} s measured, "
              f"{meta['roofline']['roofline_step_time_s']:.4f} s at the "
              f"roofline ({meta['roofline']['bottleneck']}) ({card})")
        check(got == meta["kernel_calls"] == rec["kernel_calls"] and
              total == {k: 2 * v for k, v in got.items()},
              f"{arch} {shape}: launches {got} ({total} with the timed "
              f"step), trace {meta['kernel_calls']}, card trace "
              f"{rec['kernel_calls']}")
        check(flops == want, f"{arch} {shape}: FLOPs {flops} != {want}")
        check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
              f"{arch} {shape}: peak ratio {ratio:.3f} outside {PEAK_BAND}")
        for k, v in total.items():
            launches[k] += v
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _flash_long(dev, launches: int, card: str) -> dict:
    """bf16 flash at FLASH_LONG, causal: the kernel against its plain
    version (query blocks of FLASH_LONG_BLOCK rows, each against the keys
    up to its last row: every output row, without the whole [S, S]
    scores), then kernel, SDPA (k, v expanded to the query heads first,
    so that its flash backend takes them) and the plain version timed,
    beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_work
    b, s, hq, hkv, d = FLASH_LONG
    q, k, v = _flash_inputs(b, s, s, hq, hkv, d, torch.bfloat16, dev, s + d)
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731

    def plain():
        return torch.cat([fa.flash_attention_ref(
            q[:, i:i + FLASH_LONG_BLOCK], k[:, :i + FLASH_LONG_BLOCK],
            v[:, :i + FLASH_LONG_BLOCK], causal=True, q_offset=i)
            for i in range(0, s, FLASH_LONG_BLOCK)], dim=1)
    got = kern()
    sync()
    want = plain()
    err, ok = _err(got, want, FLASH_TOL["bfloat16"])
    share, in_ulp = _bf16_ulp_close(got, want)
    del got, want
    check(ok and in_ulp and share <= FLASH_BF16_SHARE,
          f"flash {FLASH_LONG} bf16 causal: kernel != plain (max |err| "
          f"{err}, {share:.2%} of outputs differ, within one ulp: {in_ulp})")
    print(f"[lm kernel] flash dry-run prefill {list(FLASH_LONG)} bfloat16 "
          f"causal: max |kernel - plain| {err!r} (tol "
          f"{FLASH_TOL['bfloat16']}) over all {s} rows in blocks of "
          f"{FLASH_LONG_BLOCK}; {share:.3%} of outputs differ, all within "
          f"one bf16 ulp")
    g = hq // hkv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib1, ms1, ms2, lib2 = (device_ms(f, 10) for f in (sdpa, kern, kern,
                                                       sdpa))
    ms, lib_ms = min(ms1, ms2), min(lib1, lib2)
    plain_ms = device_ms(plain, 2)
    flops, nbytes = flash_work(b, s, s, hq, hkv, d, True, 2)
    bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"[times] flash_attention dry-run prefill bf16 causal "
          f"{list(FLASH_LONG)}: device time kernel {ms:.4f} ms ({ms1:.4f}, "
          f"{ms2:.4f}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
          f"({lib1:.4f}, {lib2:.4f}); bound {bound_ms:.6f} ms ({by}; {flops} "
          f"flops, {nbytes} bytes), {bound_ms / ms:.1%} of the bound "
          f"reached ({card})")
    return {"launch": f"dry run smollm-135m prefill_32k {list(FLASH_LONG)} "
                      f"causal", "launches": launches, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "err": err}


def _ssd_long(dev, launches: int, card: str) -> dict:
    """bf16 SSD at SSD_LONG: the kernel against its plain version, whole,
    then timed beside its bound."""
    import torch
    from repro_torch.kernels import ssd
    b, s, h, p, n, chunk = SSD_LONG
    x, dt, A, B, C = _ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, s)
    y, st = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    sync()
    y_r, st_r = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    err, ok = _err(y, y_r, SSD_TOL["bfloat16"])
    serr, sok = _err(st, st_r, SSD_TOL["float32"])
    big = float(y_r.float().abs().max())
    del y, st, y_r, st_r
    check(ok and sok, f"ssd {SSD_LONG} bf16: kernel != plain (y {err}, "
                      f"state {serr})")
    print(f"[lm kernel] ssd dry-run prefill {list(SSD_LONG)} bfloat16: max "
          f"|kernel - plain| y {err!r}, state {serr!r} (tol "
          f"{SSD_TOL['bfloat16']} + {SSD_TOL['bfloat16']} |plain|; the "
          f"largest |plain| y {big!r})")
    t = _time_ssd("dry-run prefill", b, s, h, p, n, chunk, dev, card)
    return {"launch": f"dry run mamba2-370m prefill_32k [{b}, {s}, {h}, "
                      f"{p}] n={n} chunk={chunk}", "launches": launches,
            **t, "err": err}


def _with_entry(record: dict, entry: dict, card: str) -> dict:
    """``record`` (a kernel's line) with one more main-path launch shape."""
    err = entry.pop("err")
    entries = record["per_launch"] + [entry]
    total = _summed(f"{record['name']}, with the dry run's shape", entries,
                    card)
    libs = [e["library_ms"] for e in entries]
    return {**record, **total,
            "launches": sum(e["launches"] for e in entries),
            "max_abs_err": max(record["max_abs_err"], err),
            "library_ms": None if None in libs else sum(libs)}


def phase_dryrun(dev, sweep, lm_records: list, card: str) -> list:
    """Phase 11: the dry run — the sweep's 64 records, four cells' per-
    device steps on the card against their meta traces, the flash and SSD
    kernels at the 32k prefill shapes against their plain versions and
    timed; returns the kernel records with those shapes added."""
    t0 = time.perf_counter()
    recs = _dryrun_records(sweep, card)
    launches = _dryrun_on_card(recs, card)
    flash = _flash_long(dev, launches["flash_attention"], card)
    ssd_entry = _ssd_long(dev, launches["ssd_scan"], card)
    out = [_with_entry(r, flash if r["name"].startswith("flash") else
                       ssd_entry, card) for r in lm_records]
    RUN["phase11_s"] = time.perf_counter() - t0
    print(f"[dryrun] phase 11: {RUN['phase11_s']:.1f} s on top of the "
          f"sweep's child process; the (d2) cut saved about "
          f"{RUN['d2_saved_s']:.1f} s ({card})")
    return out


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
    sweep = start_dryrun_sweep()
    try:
        return _run_phases(dev, sweep, card, t_all)
    finally:
        if sweep[0].poll() is None:
            sweep[0].kill()
        sweep[0].wait()


def _run_phases(dev, sweep, card: str, t_all: float) -> int:
    import torch
    if sys.argv[1:] == ["--phase", "10"]:     # the mesh phase alone
        from repro_torch.cachesim import SimConfig, get_trace, run_policies
        cfg_b = SimConfig(n_caches=8, costs=(1.0, 2.0, 3.0, 1.5) * 2,
                          alg="exhaustive", **PAPER)
        res_b = run_policies(get_trace("gradle", N_REQUESTS, seed=0), cfg_b,
                             ("fno", "fna", "pi"), device=dev)
        grid_launches, grid_cold = phase_grid(dev, cfg_b, res_b, card)
        phase_mesh(dev, grid_cold, grid_launches["cold"], card)
        print(f"[done] {time.perf_counter() - t_all:.1f} s; phases 1, 6 "
              f"and 10 only: no result")
        return 1
    if sys.argv[1:] == ["--phase", "8"]:      # the LM serving path alone
        lm_records = phase_lm(dev, card)
        print(f"[done] {time.perf_counter() - t_all:.1f} s; phases 1 and 8 "
              f"only: no result")
        print(card)
        print(json.dumps({"kernels": lm_records}))
        return 1
    if sys.argv[1:] == ["--phase", "11"]:     # the dry run alone
        recs = _dryrun_records(sweep, card)
        launches = _dryrun_on_card(recs, card)
        _flash_long(dev, launches["flash_attention"], card)
        _ssd_long(dev, launches["ssd_scan"], card)
        print(f"[done] {time.perf_counter() - t_all:.1f} s; phases 1 and 11 "
              f"only: no result")
        return 1
    phase_kernel_checks(dev)
    st_b, cfg_b, res_b, launches = phase_slice(dev, card)
    bloom_record = phase_router(dev, st_b, cfg_b, card)
    phase_serve()
    phase_golden(dev, card)
    grid_launches, grid_cold = phase_grid(dev, cfg_b, res_b, card)
    phase_topology(dev, card)
    record = phase_kernel_times(
        st_b, cfg_b, {"slice_b": launches["subset_argmin"],
                      "grid_cold": grid_launches["cold"],
                      "grid_warm": grid_launches["warm"]}, card)
    lm_records = phase_lm(dev, card)
    phase_train(dev, card)
    phase_mesh(dev, grid_cold, grid_launches["cold"], card)
    lm_records = phase_dryrun(dev, sweep, lm_records, card)
    print(f"[done] {time.perf_counter() - t_all:.1f} s in all (limit 1200 "
          f"s); phase 11 {RUN['phase11_s']:.1f} s, paid for in part by the "
          f"(d2) cut's about {RUN['d2_saved_s']:.1f} s; (h8) "
          f"{RUN['h8_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record, bloom_record, *lm_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
