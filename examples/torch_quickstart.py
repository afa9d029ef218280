"""Quickstart on the PyTorch/CUDA port: the paper's FNA cache selection.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--requests N]

1. Builds a 3-cache system with stale Bloom-filter indicators.
2. Replays a recency-biased trace (the staleness-hostile regime).
3. Compares the paper's CS_FNA, the calibrated FNA, the FNO baseline,
   and the perfect-information lower bound.

The decision tables run on the card (``cuda``, the default) unless
``--device cpu`` is given; ``examples/quickstart.py`` runs the same
comparison through the JAX package.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.cachesim import SimConfig, get_trace, run_policies  # noqa: E402

POLICIES = ("pi", "fno", "fna", "fna_cal")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=40_000)
    args = ap.parse_args(argv)
    trace = get_trace("gradle", args.requests, seed=0)
    base = SimConfig(n_caches=3, cache_size=2_000, costs=(1.0, 2.0, 3.0),
                     miss_penalty=100.0, bpe=14.0, update_interval=512)
    print("policy      mean-cost   vs-PI   hit-ratio   negative-accesses")
    res = run_policies(trace, base, policies=POLICIES, device=args.device)
    pi_cost = res["pi"].mean_cost
    for name in POLICIES:
        r = res[name]
        print(f"{name:10s} {r.mean_cost:9.3f} {r.mean_cost / pi_cost:7.3f}"
              f" {r.hit_ratio:10.3f} {r.neg_accesses:15d}")
    print("\nfna  = the paper's Algorithm 2 (Eqs. 7-9 estimation)")
    print("fna_cal = + empirical exclusion-probability feedback")
    return res


if __name__ == "__main__":
    main()
