"""Train an assigned-architecture LM on the PyTorch/CUDA port's
synthetic pipeline.

Default: reduced SmolLM, 200 steps on the card (``cuda``), loss visibly
dropping; ``--device cpu`` trains on the CPU.  The published 135M
configuration is one flag away (``--full-size``), and the same entry
point runs on a device mesh (``python -m repro_torch.launch.train --mesh
elastic``).  Checkpoints go to a temporary directory unless
``--ckpt-dir`` names one.

  PYTHONPATH=src python examples/torch_train_lm.py [--arch smollm-135m] [--steps 200] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--full-size", action="store_true",
                    help="the published config (minutes on the card, "
                         "hours on a CPU)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        train = ["--arch", args.arch, "--steps", str(args.steps),
                 "--batch", "8", "--seq", "128", "--lr", "3e-3",
                 "--device", args.device,
                 "--ckpt-dir", args.ckpt_dir or tmp, "--ckpt-interval", "100"]
        if not args.full_size:
            train.append("--reduced")
        return train_main(train)


if __name__ == "__main__":
    sys.exit(main())
