"""END-TO-END DRIVER (serving) on the PyTorch/CUDA port: an FNA-routed
distributed prefix-KV cache.

  PYTHONPATH=src python examples/torch_serve_prefix_cache.py [--requests 200] [--device cpu]

A reduced SmolLM serves requests on the card (``cuda``, the default;
``--device cpu`` for the CPU).  Prompts share prefixes (system prompts /
few-shot headers) whose prefill KV caches live on 4 cache nodes
advertising stale Bloom indicators.  The router decides which nodes to
probe with the paper's false-negative-aware policy; misses pay a real
prefill (through the flash-attention kernel on the card).  Service cost
and wall-clock are reported for FNA vs FNO routing.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.cachesim.traces import recency_trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (ClusterConfig, PrefixServeCluster,  # noqa: E402
                                 ServeEngine)

PREFIX_LEN = 24
DECODE_STEPS = 4
POLICIES = ("fno", "fna", "fna_cal", "pi")


def run(policy: str, n_requests: int, engine: ServeEngine, prefixes, stream):
    cfg = ClusterConfig(n_nodes=4, node_capacity=64, update_interval=32,
                        miss_penalty=40.0, policy=policy)
    cluster = PrefixServeCluster(cfg, seed=1)
    t0 = time.time()
    prefill_s = 0.0
    for i in range(n_requests):
        pid = int(stream[i])
        tokens = prefixes[pid % len(prefixes)]

        def make_kv():
            nonlocal prefill_s
            t1 = time.time()
            _, cache = engine.prefill(
                tokens, max_len=PREFIX_LEN + DECODE_STEPS + 2)
            prefill_s += time.time() - t1
            return cache

        kv, _ = cluster.request(pid, make_kv=make_kv)
        # decode a few tokens from the (hit or freshly built) prefix KV
        engine.decode(kv, np.zeros((tokens.shape[0],), np.int64),
                      DECODE_STEPS)
    return cluster.stats, time.time() - t0, prefill_s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m").reduced()
    engine = ServeEngine(cfg, device=args.device)
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, cfg.vocab, (1, PREFIX_LEN)).astype(np.int64)
                for _ in range(256)]
    stream = recency_trace(args.requests, p_new=0.15, window=96, seed=2)

    print(f"{args.requests} requests, reduced {cfg.name} on "
          f"{engine.device}, 4 cache nodes, update interval 32 "
          f"insertions\n")
    print("policy    mean-cost  hit-ratio  prefills  neg-probes  wall-s  "
          "prefill-s")
    out = {}
    for policy in POLICIES:
        stats, wall, prefill_s = run(policy, args.requests, engine,
                                     prefixes, stream)
        out[policy] = stats
        print(f"{policy:9s} {stats.mean_cost:8.2f} {stats.hit_ratio:9.3f} "
              f"{stats.prefills:9d} {stats.neg_probes:10d} {wall:7.1f} "
              f"{prefill_s:8.1f}")
    print("\nLower mean-cost == fewer prefill recomputes for the same "
          "indicator bandwidth (the paper's claim, on a live serving path).")
    return out


if __name__ == "__main__":
    main()
