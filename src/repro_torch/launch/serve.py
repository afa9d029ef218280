"""Serving launcher of the port: the FNA prefix-cache router replay.

``--replay`` runs the concurrent-client router replay harness
(``repro_torch.serving.replay``): N clients drive a scenario-defined
cluster regime (``--regime``) and the run reports throughput plus
p50/p99 decision latency — model-free (stub KV payloads), so the numbers
isolate the routing path the paper contributes.  The router is host code
and needs no GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --replay \\
      --regime staggered_adverts --requests 8000 --clients 8 \\
      --batch-sizes 1,4,16 --json /tmp/replay.json

The flags and output lines are the JAX package's
(``python -m repro.launch.serve``).  Its model path (prefill and decode
through ``ServeEngine``) belongs to the LM stack, which the port does not
have yet (ROADMAP A8): without ``--replay`` this launcher exits with
status 2 and says so.
"""
from __future__ import annotations

import argparse
import json
import sys


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
    ap.add_argument("--reduced", action="store_true", default=True)
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
    args = ap.parse_args(argv)

    if args.replay:
        return _run_replay(args)
    print("repro_torch.launch.serve: only --replay is available; the model "
          "path (prefill/decode through ServeEngine) waits for the port's "
          "LM stack (ROADMAP A8)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
