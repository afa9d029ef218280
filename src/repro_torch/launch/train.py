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

``--mesh elastic --model-dim N`` trains on the device mesh, as the JAX
launcher does: the process group starts from ``torch.distributed.run``'s
environment (a world of 1 when run as a single process; ``nccl`` on
``cuda``, ``gloo`` on ``cpu``, ``--backend`` to choose), the mesh is
``distributed.ft.elastic_mesh(model_dim=N)`` over the world, params, m and
v are laid out by ``distributed.sharding.param_shardings``, and step and
batch are replicated (the reference passes ``in_shardings=(shardings,
None)`` under ``activation_rules(None)``, so its data ranks repeat the
same work; so do the port's, which adds no data parallelism).  The
blocks compute tensor-parallel over the mesh's ``model`` dim on the
parameters' shards (``distributed.tp``), without sequence parallelism:
no rules are installed, as the reference installs none.  Only rank
0 prints the step lines and writes checkpoints (every rank gathers its
shards for them); ``--resume`` restores onto the new mesh, whatever mesh
saved; a preemption checkpoints and exits 42 on every rank.  Ranks beyond
the mesh are spare: they wait at a barrier for the run's end and exit 0.

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --mesh elastic --model-dim 2 ...

The summary line also carries every step's loss (``losses``), the step
seconds (``step_s``) and the mesh's shape; each other rank prints its
own peak memory on a ``[train] rank R`` line.
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
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data import (DataConfig, Prefetcher, SyntheticLMData,
                              to_device)
from repro_torch.device import resolve_device
from repro_torch.distributed.ft import (PreemptionHandler, StepTimer,
                                        elastic_mesh, is_spare)
from repro_torch.distributed.sharding import (activation_rules, distribute,
                                              param_shardings)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.launch.mesh import init_distributed, shutdown_distributed
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
    ap.add_argument("--backend", default=None,
                    help="process-group backend of --mesh elastic (nccl "
                         "on cuda, gloo on cpu by default)")
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    with deterministic():
        if args.mesh == "none":
            return _train(args, resolve_device(args.device), None)
        dev = init_distributed(args.device, args.backend)
        try:
            mesh = elastic_mesh(model_dim=args.model_dim)
            if is_spare(mesh):
                print(f"[train] rank {dist.get_rank()} is spare (mesh "
                      f"{_shape(mesh)}); waiting for the run's end")
                dist.barrier()
                return 0
            rc = _train(args, dev, mesh)
            dist.barrier()
            return rc
        finally:
            shutdown_distributed()


def _shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _train(args, dev: torch.device, mesh) -> int:
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg, model, ocfg, data = build(args)
    train_step = make_train_step(model, ocfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = _launches()

    gen = torch.Generator(dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    shardings = None
    if mesh is not None:
        say(f"[train] elastic mesh: {_shape(mesh)}")
        psh = param_shardings(mesh, params, cfg.tie_embeddings)
        params = distribute(params, mesh, psh)
        shardings = {"params": psh, "m": psh, "v": psh, "step": None}
        if ocfg.compression == "int8_ef":
            shardings["ef"] = psh
    state = init_train_state(params, ocfg)
    start = 0
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        state = restore(args.ckpt_dir, state, device=dev,
                        mesh=mesh,
                        shardings=shardings)
        start = int(state["step"])
        say(f"[train] resumed from step {start}")

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval) \
        if args.ckpt_dir else None
    preempt = PreemptionHandler().install()
    timer = StepTimer()
    prefetch = Prefetcher(data.iterate(start_step=start))
    tokens_per_step = args.batch * args.seq
    loss = float("nan")
    losses, step_s = [], []

    try:
        for step in range(start, args.steps):
            if args.kill_at == step:
                preempt.trigger()
            if preempt.preempted:
                if ckpt:
                    ckpt.maybe_save(state, step, force=True)
                    ckpt.wait()
                say(f"[train] preempted at step {step}; checkpointed, "
                    f"exit {EXIT_PREEMPTED}")
                return EXIT_PREEMPTED
            host_batch = prefetch.get()
            timer.start()
            with activation_rules(None):
                state, metrics = train_step(state,
                                            to_device(host_batch, dev))
            loss = float(metrics["loss"])
            dt = timer.stop(step)
            losses.append(loss)
            step_s.append(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{tokens_per_step / max(dt, 1e-9):,.0f} tok/s "
                      f"{dt * 1e3:.0f} ms")
            if ckpt:
                ckpt.maybe_save(state, step + 1)
        summary = {"device": dev.type, "peak_memory_bytes": None,
                   "ckpt_bytes": None, "ckpt_save_s": None,
                   "mesh": None if mesh is None else _shape(mesh),
                   "losses": losses, "step_s": step_s}
        if ckpt:
            t0 = time.perf_counter()
            ckpt.maybe_save(state, args.steps, force=True)
            ckpt.wait()
            summary["ckpt_save_s"] = time.perf_counter() - t0
            last = Path(args.ckpt_dir) / f"step_{args.steps}"
            if rank0:
                summary["ckpt_bytes"] = sum(f.stat().st_size
                                            for f in last.iterdir())
        if timer.stragglers:
            say(f"[train] straggler steps: {timer.stragglers}")
        say(f"[train] done: {args.steps} steps, final loss {loss:.4f}")
        if dev.type == "cuda":
            summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        launches = _launches()
        summary["kernel_launches"] = {k: launches[k] - launches0[k]
                                      for k in launches}
        if rank0:
            print(f"[train] summary {json.dumps(summary)}")
        else:
            print(f"[train] rank {dist.get_rank()} peak_memory_bytes "
                  f"{summary['peak_memory_bytes']}")
        return 0
    finally:
        prefetch.close()


if __name__ == "__main__":
    sys.exit(main())
