"""Serving launcher of the port: model engine + FNA prefix-cache routing
tier (the port of the JAX package's ``python -m repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 200 --policy fna_cal --device cpu

drives the full data path on one device: route -> probe -> (hit: reuse
the prefix KV | miss: a real prefill) -> decode -> place.  It runs on
``cuda`` unless ``--device cpu`` is given; ``--reduced`` (the default)
takes the architecture's tiny same-family config, ``--no-reduced`` its
published one.  Every family is served: ``dense``, ``moe`` and ``vlm``
(smollm-135m, granite-moe-3b-a800m, qwen3-moe-30b-a3b, internvl2-1b) and
``encdec`` (seamless-m4t-medium) prefill through the flash-attention
kernel, ``ssm`` (mamba2-370m) through the SSD kernel, ``hybrid``
(zamba2-7b) through both; decode is plain torch.  ``--kv-quant`` applies
to dense, moe and vlm, as in the JAX launcher.  The output lines are the
JAX launcher's, between a ``[serve] weights`` line (parameters, and the
seconds it took to draw them) and a closing ``[serve] decoded`` line (the
tokens decoded, the wall time and the prefills' share of it); the prefill
seconds are taken after a device sync, and ``tok/s`` divides the decoded
tokens by the time spent in ``ServeEngine.decode``, which ends with the
last token's copy to the host.  ``--spans PATH`` turns on the program's
span recorder (``repro_torch.tracing``) and writes the spans to PATH as
Chrome-trace JSON at the end.  The
weights are drawn from seed 0 on the serving device (``init_params``),
so ``--device cpu`` and ``--device cuda`` serve different random
weights; the routing statistics do not depend on them.

``--replay`` runs the concurrent-client router replay harness
(``repro_torch.serving.replay``): N clients drive a scenario-defined
cluster regime (``--regime``) and the run reports throughput plus
p50/p99 decision latency — model-free (stub KV payloads), so the numbers
isolate the routing path the paper contributes.  The router is host code
and needs no GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --replay \\
      --regime staggered_adverts --requests 8000 --clients 8 \\
      --batch-sizes 1,4,16 --json /tmp/replay.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch import tracing


def _run_replay(args) -> int:
    from repro_torch.serving.replay import batch_sweep

    batches = [int(b) for b in str(args.batch_sizes).split(",") if b]
    reports = batch_sweep(args.regime, policy=args.policy,
                          batch_sizes=batches, n_requests=args.requests,
                          n_clients=args.clients, mode=args.mode,
                          seed=args.seed)
    for r in reports:
        print(f"[replay] regime={r.regime} policy={r.policy} "
              f"clients={r.n_clients} batch={r.batch_size} "
              f"reqs={r.requests} rps={r.achieved_rps:,.0f} "
              f"p50={r.p50_us:.1f}us p99={r.p99_us:.1f}us "
              f"mean-cost={r.mean_cost:.2f} hit={r.hit_ratio:.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([r.to_dict() for r in reports], f, indent=1)
        print(f"[replay] wrote {args.json}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the architecture's tiny same-family config "
                         "(default); --no-reduced runs the published one")
    ap.add_argument("--device", default="cuda",
                    help="device of the model path (cuda or cpu)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--policy", default="fna_cal",
                    choices=["fna", "fna_cal", "fno", "pi"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--node-capacity", type=int, default=64)
    ap.add_argument("--update-interval", type=int, default=32)
    ap.add_argument("--miss-penalty", type=float, default=40.0)
    ap.add_argument("--prefix-len", type=int, default=24)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 prefix-KV caches (model path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay", action="store_true",
                    help="concurrent-client router replay (model-free): "
                         "throughput + p50/p99 decision latency")
    ap.add_argument("--regime", default="hetero_tiers",
                    help="--replay cluster regime (see "
                         "repro_torch.serving.replay.REGIMES)")
    ap.add_argument("--clients", type=int, default=4,
                    help="--replay concurrent client count")
    ap.add_argument("--batch-sizes", default="1",
                    metavar="B[,B...]",
                    help="--replay per-turn request batch sizes; several "
                         "values sweep (fresh cluster each)")
    ap.add_argument("--mode", choices=("threads", "sequential"),
                    default="threads",
                    help="--replay client model: threaded (live "
                         "contention) or deterministic round-robin")
    ap.add_argument("--json", default="",
                    help="--replay: write the reports to this path")
    ap.add_argument("--spans", default="", metavar="PATH",
                    help="record the program's spans and write them to "
                         "PATH as Chrome-trace JSON")
    args = ap.parse_args(argv)

    if args.spans:
        tracing.clear()
        tracing.enable()
    try:
        return _run_replay(args) if args.replay else _run_model(args)
    finally:
        if args.spans:
            tracing.disable()
            n = tracing.write(args.spans)
            print(f"[serve] wrote {n} spans to {args.spans}")


def _run_model(args) -> int:
    import torch

    from repro_torch.cachesim.traces import recency_trace
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.serving import (ClusterConfig, PrefixServeCluster,
                                     ServeEngine)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_quant and cfg.family in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, kv_quant=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    engine = ServeEngine(cfg, device=dev)
    sync()
    print(f"[serve] weights arch={cfg.name} params={cfg.param_count()} "
          f"drawn on {dev.type} in {time.time() - t0:.3f}s")
    rng = np.random.default_rng(args.seed)
    prefixes = [rng.integers(0, cfg.vocab, (1, args.prefix_len)).astype(np.int32)
                for _ in range(256)]
    stream = recency_trace(args.requests, p_new=0.15, window=96,
                           seed=args.seed + 1)

    ccfg = ClusterConfig(n_nodes=args.nodes, node_capacity=args.node_capacity,
                         update_interval=args.update_interval,
                         miss_penalty=args.miss_penalty, policy=args.policy)
    cluster = PrefixServeCluster(ccfg, seed=args.seed)
    max_len = args.prefix_len + args.decode_steps + 2

    t0 = time.time()
    prefill_s = decode_s = 0.0
    tokens_out = 0
    for i in range(args.requests):
        pid = int(stream[i])
        toks = prefixes[pid % len(prefixes)]

        def make_kv():
            nonlocal prefill_s
            t1 = time.time()
            _, c = engine.prefill(toks, max_len=max_len)
            sync()
            prefill_s += time.time() - t1
            return c

        kv, cost = cluster.request(pid, make_kv=make_kv)
        first = np.zeros((toks.shape[0],), np.int32)
        t1 = time.time()
        out, _ = engine.decode(kv, first, args.decode_steps)
        decode_s += time.time() - t1
        tokens_out += out.size
        if (i + 1) % 50 == 0:
            s = cluster.stats
            print(f"[serve] {i + 1:5d} reqs  mean-cost {s.mean_cost:7.2f}  "
                  f"kv-hit {s.hit_ratio:.3f}  prefills {s.prefills}  "
                  f"neg-probes {s.neg_probes}")
    wall = time.time() - t0
    s = cluster.stats
    print(f"[serve] policy={args.policy} requests={s.requests} "
          f"mean-cost={s.mean_cost:.2f} hit={s.hit_ratio:.3f} "
          f"prefills={s.prefills} neg_probes={s.neg_probes} "
          f"tok/s={tokens_out / decode_s:,.0f} wall={wall:.1f}s "
          f"(prefill {prefill_s:.1f}s)")
    print(f"[serve] decoded tokens={tokens_out} in {wall:.3f}s "
          f"(prefill {prefill_s:.3f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
