"""Run one cell of the benchmark of the PyTorch/CUDA port (``repro_torch``)
on the card and print its result as the last line of standard output.

  python3 bench/run.py --workload mamba2-370m.docqa --seed 7 --seconds 51 \\
      --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window. Every run checks
what the timed path produced against the plain references and prints the
numbers compared beside their limits, last on standard error and under
``checks`` in the result. It prints no result, and exits 3, if JAX or
the JAX package (``repro``) was loaded by the time it would. Without a
CUDA card (or with fewer than the cell asks for) it exits 2 and prints
no result; it never falls back to the CPU."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The benchmark and the program import from the checkout; kernel and
    compiler caches stay inside it, at fixed paths."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), device="cuda:0")
    barred = harness.barred_modules()
    if barred:
        print(f"modules of JAX or of the JAX package loaded: {barred}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
