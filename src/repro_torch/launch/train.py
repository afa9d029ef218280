"""Training launcher of the port (the port of the JAX package's
``python -m repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

trains any of the ten ``--arch``es on ``cuda`` unless ``--device cpu``
is given (add ``--reduced`` for the architecture's tiny same-family
config there: as in the JAX launcher, the default is the published one).
The weights are drawn from ``--seed`` on the training device, so ``cpu``
and ``cuda`` start from different random weights.  The printed lines are
the JAX launcher's (``[train] step ... loss ... gnorm ... tok/s ... ms``,
``[train] done: N steps, final loss X``), then one ``[train] summary``
line, a JSON object: the device, its peak memory (``cuda`` only), the
final checkpoint's bytes and the seconds its save took, and the flash and
SSD kernel launches of the run (training reaches no kernel: every
gradient runs through plain, differentiable torch — ``attention_chunked``
and ``ssd_chunked`` — as the JAX package's loss does).

Fault-tolerance drill:
  * SIGTERM mid-run -> checkpoint + exit code 42 (a scheduler restarts
    with ``--resume``, which continues from the latest checkpoint bit for
    bit: the data stream is a pure function of the step counter).
  * ``--kill-at N`` simulates a preemption at step N.

Bit-exact resume on the card needs deterministic kernels: the launcher
sets ``torch.use_deterministic_algorithms(True)`` and
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before its first CUDA operation (and
restores both when it returns).  Without them the backward passes of the
embedding gather, the loss's gold-logit gather and the MoE dispatch
gathers accumulate with atomics, in a different order each run.

``--mesh elastic`` needs the device mesh, which the port has not yet
(ROADMAP A8 item 6), and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, Prefetcher, SyntheticLMData,
                              to_device)
from repro_torch.device import resolve_device
from repro_torch.distributed.ft import PreemptionHandler, StepTimer
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.models import get_model, init_params
from repro_torch.optim import OptConfig, init_train_state, make_train_step

EXIT_PREEMPTED = 42
CUBLAS_WORKSPACE = ":4096:8"


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    ocfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     total_steps=args.steps,
                     compression="int8_ef" if args.compress_grads else "none")
    data = SyntheticLMData(DataConfig(batch=args.batch, seq=args.seq,
                                      vocab=min(cfg.vocab, 256),
                                      seed=args.seed), model_cfg=cfg)
    return cfg, model, ocfg, data


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms and a fixed cuBLAS workspace while open;
    the previous settings afterwards."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    flag = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(flag)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _launches():
    return {**fa.LAUNCHES, **ssd.LAUNCHES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="training device (cuda or cpu)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "elastic"])
    ap.add_argument("--model-dim", type=int, default=1)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.mesh == "elastic":
        raise NotImplementedError(
            "--mesh elastic needs the device mesh, which the port has not "
            "yet (ROADMAP A8 item 6)")
    with deterministic():
        return _train(args)


def _train(args) -> int:
    dev = resolve_device(args.device)
    cfg, model, ocfg, data = build(args)
    train_step = make_train_step(model, ocfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = _launches()

    gen = torch.Generator(dev).manual_seed(args.seed)
    state = init_train_state(init_params(cfg, gen, device=dev), ocfg)
    start = 0
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        state = restore(args.ckpt_dir, state, device=dev)
        start = int(state["step"])
        print(f"[train] resumed from step {start}")

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval) \
        if args.ckpt_dir else None
    preempt = PreemptionHandler().install()
    timer = StepTimer()
    prefetch = Prefetcher(data.iterate(start_step=start))
    tokens_per_step = args.batch * args.seq
    loss = float("nan")

    try:
        for step in range(start, args.steps):
            if args.kill_at == step:
                preempt.trigger()
            if preempt.preempted:
                if ckpt:
                    ckpt.maybe_save(state, step, force=True)
                    ckpt.wait()
                print(f"[train] preempted at step {step}; checkpointed, "
                      f"exit {EXIT_PREEMPTED}")
                return EXIT_PREEMPTED
            host_batch = prefetch.get()
            timer.start()
            state, metrics = train_step(state, to_device(host_batch, dev))
            loss = float(metrics["loss"])
            dt = timer.stop(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{tokens_per_step / max(dt, 1e-9):,.0f} tok/s "
                      f"{dt * 1e3:.0f} ms")
            if ckpt:
                ckpt.maybe_save(state, step + 1)
        summary = {"device": dev.type, "peak_memory_bytes": None,
                   "ckpt_bytes": None, "ckpt_save_s": None}
        if ckpt:
            t0 = time.perf_counter()
            ckpt.maybe_save(state, args.steps, force=True)
            ckpt.wait()
            summary["ckpt_save_s"] = time.perf_counter() - t0
            last = Path(args.ckpt_dir) / f"step_{args.steps}"
            summary["ckpt_bytes"] = sum(f.stat().st_size
                                        for f in last.iterdir())
        if timer.stragglers:
            print(f"[train] straggler steps: {timer.stragglers}")
        print(f"[train] done: {args.steps} steps, final loss {loss:.4f}")
        if dev.type == "cuda":
            summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        launches = _launches()
        summary["kernel_launches"] = {k: launches[k] - launches0[k]
                                      for k in launches}
        print(f"[train] summary {json.dumps(summary)}")
        return 0
    finally:
        prefetch.close()


if __name__ == "__main__":
    sys.exit(main())
