"""Fault-tolerance drill on the PyTorch/CUDA port: preemption ->
checkpoint -> restart.

  PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

1. Trains a reduced model, killing it (SIGTERM semantics) at step 12.
2. Restarts from the atomic checkpoint and finishes.
3. Verifies the final loss equals an uninterrupted run bit for bit (the
   data pipeline is a pure function of the step counter, and the
   launcher runs deterministic algorithms).

Each run is ``python -m repro_torch.launch.train`` in a child process,
on the card (``cuda``, the default) unless ``--device cpu`` is given.
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True)
    if check and r.returncode not in (0, 42):
        print(r.stdout, r.stderr)
        raise SystemExit(1)
    return r


def final_loss(stdout: str) -> float:
    for line in reversed(stdout.splitlines()):
        if "final loss" in line:
            return float(line.rsplit(" ", 1)[-1])
    raise ValueError("no final loss in output")


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--kill-at", type=int, default=12)
    args = ap.parse_args(argv)
    common = ["--arch", "smollm-135m", "--reduced", "--steps",
              str(args.steps), "--batch", "4", "--seq", "64",
              "--ckpt-interval", "5", "--device", args.device]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        print("== uninterrupted run ==")
        ref = final_loss(run(common + ["--ckpt-dir", d1]).stdout)
        print(f"   final loss {ref}")

        print(f"== preempted at step {args.kill_at} ==")
        r1 = run(common + ["--ckpt-dir", d2, "--kill-at", str(args.kill_at)])
        assert r1.returncode == 42, r1.returncode
        print("   exit 42 (checkpointed)")

        print("== restart ==")
        got = final_loss(run(common + ["--ckpt-dir", d2, "--resume"]).stdout)
        print(f"   final loss {got}")
        assert got == ref, (got, ref)
        print("OK: restart is bit-exact")
    return got


if __name__ == "__main__":
    main()
