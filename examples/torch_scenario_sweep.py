"""Run a named scenario on the PyTorch/CUDA port and print its policy
grid as a table.

The scenario registry (``repro_torch.cachesim.scenarios``) names the
paper's figure setups plus heterogeneous beyond-paper regimes; this
example runs one of them at a small scale and tabulates mean service cost
per (trace, cell, policy).

    PYTHONPATH=src python examples/torch_scenario_sweep.py [scenario] [n_requests] [--device cpu]

Defaults: ``hetero_tiers`` (cheap-small vs expensive-large cache tiers)
at 20k requests, on ``cuda``.  ``pivot_cells`` and ``normalised`` are
copies of the figure pipeline's (``benchmarks/paper_figs.py``), which
the port does not import.
"""
import argparse
import sys
from pathlib import Path
from typing import Dict, List, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.cachesim import get_scenario, run_scenario  # noqa: E402
from repro_torch.cachesim.sweep import axis_column, hashable_label  # noqa: E402


def pivot_cells(records: Sequence[dict], axis: str) -> List[dict]:
    """Group flat per-policy records into one dict per (scenario, trace,
    cell): ``{"trace", axis, "cost": {policy: mean_cost}, ...}``, cells in
    first-seen order."""
    axis = axis_column(axis)
    cells: Dict[tuple, dict] = {}
    for r in records:
        key = (r.get("scenario"), r["trace"], hashable_label(r[axis]))
        cell = cells.setdefault(key, {
            "scenario": r.get("scenario"), "trace": r["trace"],
            axis: r[axis], "cost": {},
            "hit_ratio": {}, "neg_accesses": {},
            "fn_ratio": r["fn_ratio"], "fp_ratio": r["fp_ratio"],
        })
        cell["cost"][r["policy"]] = r["mean_cost"]
        cell["hit_ratio"][r["policy"]] = r["hit_ratio"]
        cell["neg_accesses"][r["policy"]] = r["neg_accesses"]
    return list(cells.values())


def normalised(cell: dict) -> Dict[str, float]:
    """Per-policy cost normalised by the PI lower bound (paper y-axis)."""
    pi = cell["cost"].get("pi")
    if not pi:
        return dict(cell["cost"])
    return {p: c / pi for p, c in cell["cost"].items()}


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", nargs="?", default="hetero_tiers")
    ap.add_argument("n_requests", nargs="?", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sc = get_scenario(args.scenario)
    print(f"scenario {sc.name} ({sc.figure}): {sc.description}\n"
          f"axis={sc.axis}  traces={','.join(sc.traces)}  "
          f"n_requests={args.n_requests}\n")
    records = run_scenario(sc, n_requests=args.n_requests,
                           device=args.device)
    cells = pivot_cells(records, sc.axis)
    policies = list(sc.policies)
    head = f"{'trace':>8s} {sc.axis:>18s}" + "".join(
        f" {p:>9s}" for p in policies) + "   (cost / PI-normalised)"
    print(head)
    print("-" * len(head))
    for cell in cells:
        norm = normalised(cell)
        row = f"{cell['trace']:>8s} {str(cell[axis_column(sc.axis)]):>18s}"
        for p in policies:
            row += f" {cell['cost'][p]:9.3f}"
        row += "   " + " ".join(f"{p}={norm[p]:.2f}" for p in policies
                                if p != "pi")
        print(row)
    return cells


if __name__ == "__main__":
    main()
