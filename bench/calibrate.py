"""The readings that the correctness limits are set from, on the card:
for each seed, the program's numbers (a short window at the cell's own
load and sizes) and, for the first ``--control`` seeds, the control's,
the float32 reference computed in fp8 in the program's place, on the same
documents and tokens.  Both come from ``harness.verify``, the comparison
that decides ``correct``.  One process serves every seed, so that set-up
is paid once for imports and kernel loads.

  python3 bench/calibrate.py --workload mamba2-370m.docqa \\
      --seeds 11 12 13 --control 3 --seconds 12 --out chiprun_out/cal.jsonl

Each seed prints one JSON line (and appends it to ``--out``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from run import ROOT, _paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds (the first) also read the "
                         "control")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for n, seed in enumerate(args.seeds):
        t0 = time.time()
        sv = harness.serve_cell(cell, seed, args.seconds, False,
                                device="cuda:0", t_start=t0)
        row = {"workload": args.workload, "seed": seed,
               "requests": len(sv.window),
               "hits": sum(r.hit for r in sv.window)}
        for side in ("program", "control")[:1 + (n < args.control)]:
            t1 = time.time()
            checks, info = harness.verify(cell, sv, seed,
                                          control=side == "control")
            row[side] = {k: c["value"] for k, c in checks.items()}
            row[side].update(info, seconds=round(time.time() - t1, 3))
        row["seconds"] = round(time.time() - t0, 3)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            path = ROOT / args.out
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a") as f:
                f.write(line + "\n")
        del sv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
