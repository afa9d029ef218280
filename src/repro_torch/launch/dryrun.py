"""Multi-pod dry run of the port: trace every (arch x shape) cell's
per-device step on the production meshes and write its roofline.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]

The counterpart of the JAX package's ``repro.launch.dryrun``, which
lowers and compiles each cell for 512 placeholder devices and reads the
compiled HLO.  The port has no HLO, so a cell here is traced: a ``fake``
process group of 256 or 512 ranks in this one process
(``launch.mesh.fake_world``) holds the (16, 16) ``("data", "model")`` or
(2, 16, 16) ``("pod", "data", "model")`` mesh; the state or parameters
are built on the meta device (shapes only, nothing drawn) and laid out
on it as DTensors (``distributed.sharding``); the inputs are meta tensors
of one rank's shapes (``models.input_specs`` with the batch cut over the
data axes); and the port's real step runs once under the cost trace
(``launch.cost.CostTrace``):

  * train   — ``optim.make_train_step`` (loss, gradients, clip, AdamW);
  * prefill — the model's ``prefill``, which reaches the flash and SSD
              kernels' meta paths;
  * decode  — the model's ``decode_step``.

What the per-device step is: the reference's ``lower_cell`` with its
``in_shardings`` as the inputs' layouts (``launch.specs.lay_out``) —
the train state by ``state_shardings`` (ZeRO-1 moments), the batch by
``batch_shardings``, the decode cache by ``cache_shardings`` and the
tokens by ``token_shardings`` — under ``activation_rules(make_rules(mesh,
cfg))``, as ``src/repro/launch/dryrun.py:72-108`` installs them.  Every
cell computes its blocks tensor-parallel over ``model`` on the
parameters' shards (``distributed.tp``: the activations' column gathers,
the float32 all-reduces of the row-parallel products, the
vocab-parallel embedding and head; the residual sequence-parallel
between blocks, the row-parallel products reduce-scattered over the
sequence; the SSM state and conv cache on the rank's heads and
channels).  A train cell runs that step's backward too (each
collective's: the sequence gathers' reduce-scatters, the
reduce-scatters' all-gathers, the vocab-parallel cross-entropy's
all-reduces) on its rank's rows, data-parallel (the gradient
reduce-scattered over the data axes into the ZeRO-1 layout, the new
parameters all-gathered back); a decode cell attends over its slice of
the KV sequence (all-reduces of the softmax statistics and of the
partial outputs); and a MoE cell's dispatch takes expert parallelism
(all-to-alls over ``model``, or in decode the rank's experts and an
all-gather of their outputs).  The record's ``departures`` name how
the port lays the step out where the reference leaves it to GSPMD.

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference record's keys where their meaning carries
(``memory_analysis``, ``collectives``, ``roofline`` on the H100's
constants (``launch.roofline``), ``essential_bytes_per_device``,
``attn_score_bytes``, ``convert_bytes``) and ``trace_device``,
``trace_s``, ``ops`` and ``kernel_calls``.  ``memory_analysis``:
``argument_size_in_bytes`` — the step's inputs on one rank (local
shards); ``output_size_in_bytes`` — its outputs (``alias_size_in_bytes``
of them held in the inputs' storage: the decode cache, written in
place); ``temp_size_in_bytes`` — the trace's peak live bytes of the
storages the step allocated (its outputs among them), the caching
allocator's model in ``launch.cost``.

The meta device is the dry run's by nature: it needs no values and 256 to
512 ranks that no single host has; the trace never falls back to the CPU.
``trace_cell(..., device="cuda")`` runs the same per-device step on the
card (parameters, state and inputs zeros, the fake group's collectives
leaving their buffers unwritten), for comparing the trace with the card.
The sweep is resumable (existing JSONs are skipped without ``--force``)
and fails loudly: it lists every failed cell and exits 1.  ``--mesh
both`` runs one child process per mesh kind, the two at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (BlockShard,
                                              activation_rules, batch_dims,
                                              distribute, like, local,
                                              local_batch, mesh_size,
                                              param_shardings)
from repro_torch.launch import specs as S
from repro_torch.launch.cost import CostTrace
from repro_torch.launch.mesh import (data_axes, fake_world,
                                     make_production_mesh)
from repro_torch.launch.roofline import (CARD, Roofline, axes_within_node,
                                         essential_bytes, model_flops)
from repro_torch.models import get_model, init_params, input_specs
from repro_torch.optim import OptConfig, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESHES = {"single": 256, "multi": 512}
#: the port's departures from the reference design that a record names
DEPARTURES = {
    "tp_training": True,
    "tp_serving": True,
    "zero1": True,
    "expert_parallel": True,
    "kv_cache_sequence_sharded": True,
    "dp_gradient_reduce": True,
}


def cell_config(arch: str, shape_name: str, *, serve_bf16: bool = False,
                kv_quant: bool = False) -> ModelConfig:
    """The published config of ``arch`` with the dry run's serving
    options: ``serve_bf16`` stores serving weights in bf16, ``kv_quant``
    gives decode cells the int8 KV cache."""
    cfg = get_config(arch)
    if serve_bf16 and shape_name.startswith(("decode", "long", "prefill")):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if kv_quant and shape_name.startswith(("decode", "long")):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg


def device_batch(shape: ShapeConfig, dp: int) -> int:
    """One rank's share of the global batch over ``dp`` data ranks (the
    whole batch when it does not divide: long_500k's B = 1)."""
    b = shape.global_batch
    return b // dp if b % dp == 0 else b


def _materialise(tree, dev: torch.device):
    """Every meta leaf (a DTensor's or ZeRO-1 block's local part) as zeros
    on ``dev``."""
    from torch.distributed.tensor import DTensor

    def leaf(x):
        if isinstance(x, (DTensor, BlockShard)):
            return like(x, torch.zeros(x.to_local().shape, dtype=x.dtype,
                                       device=dev))
        if not isinstance(x, torch.Tensor):
            return x
        return torch.zeros(x.shape, dtype=x.dtype, device=dev)
    return tree_map(leaf, tree)


def _storages(tree) -> Dict[int, int]:
    """{storage: bytes} of the distinct storages of a step's inputs or
    outputs (a DTensor's local shard)."""
    out = {}
    for x in tree_leaves(_flat(tree)):
        x = local(x)
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _flat(tree):
    """A step's inputs or outputs as nested dicts and lists (tuples
    listed)."""
    if isinstance(tree, tuple):
        return [_flat(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_flat(v) for v in tree]
    return tree


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, dev: torch.device,
               batch: Optional[int] = None):
    """(step function, its arguments) of one rank on ``dev`` (``meta``:
    shapes only).  On ``mesh`` the inputs are the shape's global ones laid
    out as the reference's ``in_shardings`` say (``launch.specs``; this
    rank keeps its part) and the step runs under the mesh's activation
    rules; with None, one device with plain tensors at ``batch`` rows
    (the shape's global batch when None)."""
    model = get_model(cfg)
    params = init_params(cfg, device="meta")
    inputs = input_specs(cfg, shape, None if mesh is not None else batch)
    if shape.kind == "train":
        ocfg = OptConfig()
        step = make_train_step(model, ocfg)
        args = [init_train_state(params, ocfg), inputs["batch"]]
        if mesh is not None:
            args = [S.lay_out(args[0], mesh,
                              S.state_shardings(mesh, cfg, args[0])),
                    S.lay_out(args[1], mesh,
                              S.batch_shardings(mesh, cfg, args[1]))]
    else:
        if mesh is not None:
            params = distribute(params, mesh, param_shardings(
                mesh, params, cfg.tie_embeddings))
        if shape.kind == "prefill":
            def step(params, batch):
                if not batch_dims(batch):
                    return model.prefill(params, batch)
                with local_batch():     # this rank's rows
                    return model.prefill(params, {k: local(v) for k, v
                                                  in batch.items()})
            args = [params, inputs["batch"]]
            if mesh is not None:
                args[1] = S.lay_out(args[1], mesh, S.batch_shardings(
                    mesh, cfg, args[1]))
        else:
            step = model.decode_step
            args = [params, inputs["cache"], inputs["tokens"]]
            if mesh is not None:
                args[1] = S.lay_out(args[1], mesh, S.cache_shardings(
                    mesh, cfg, args[1], shape))
                args[2] = S.lay_out(args[2], mesh,
                                    S.token_shardings(mesh, shape))
    if dev.type != "meta":
        args = [_materialise(a, dev) for a in args]
    if mesh is None:
        return step, tuple(args)
    rules = S.make_rules(mesh, cfg)

    def ruled(*a):
        with activation_rules(rules):
            return step(*a)
    return ruled, tuple(args)


def run_traced(step, args) -> Dict:
    """``step(*args)`` once under a :class:`CostTrace`: the trace's summary
    with the memory analysis and the seconds it took.  On the card also
    ``card``: the caching allocator's peak above what was allocated
    before the step (``peak_bytes``) and the seconds of a second,
    untraced call (``step_s``, ended by a device sync), and the kernel
    launches of the traced call (``launches``, read from the kernels'
    counters around it)."""
    dev = next(t.device for t in tree_leaves(_flat(args))
               if isinstance(t, torch.Tensor))
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        launched = _launches()
    t0 = time.perf_counter()
    with CostTrace() as tr:
        out = step(*args)
    secs = time.perf_counter() - t0
    ins, outs = _storages(args), _storages(out)
    summary = tr.summary()
    summary["memory_analysis"] = {
        "argument_size_in_bytes": sum(ins.values()),
        "output_size_in_bytes": sum(outs.values()),
        "alias_size_in_bytes": sum(v for k, v in outs.items() if k in ins),
        "temp_size_in_bytes": summary["peak_live_bytes"],
    }
    summary["trace_s"] = secs
    summary["top_ops"] = tr.top_ops(15)
    if on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        now = _launches()
        launched = {k: now[k] - launched[k] for k in now
                    if now[k] > launched[k]}
        del out
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize(dev)
        summary["card"] = {"peak_bytes": peak, "launches": launched,
                           "step_s": time.perf_counter() - t0}
    return summary


def _launches() -> Dict[str, int]:
    """The kernels' launch counters (``LAUNCHES``) as they stand."""
    from repro_torch.kernels import flash_attention, ssd
    return {**flash_attention.LAUNCHES, **ssd.LAUNCHES}


def trace_cell(arch: str, shape_name: str, mesh_kind: str, *,
               device: str = "meta", serve_bf16: bool = False,
               kv_quant: bool = False) -> Dict:
    """One cell's per-device step traced in a fake world of the mesh's
    ranks on ``device`` (``meta``, or ``cuda`` to run it on the card):
    the record of :func:`run_cell` without the file."""
    dev = torch.device(device)
    if dev.type not in ("meta", "cuda"):
        raise ValueError(f"the dry run traces on meta or cuda, not {dev}")
    cfg = cell_config(arch, shape_name, serve_bf16=serve_bf16,
                      kv_quant=kv_quant)
    shape = get_shape(shape_name)
    chips = MESHES[mesh_kind]
    t0 = time.perf_counter()
    with fake_world(chips):
        mesh = make_production_mesh(
            multi_pod=mesh_kind == "multi",
            device_type="cuda" if dev.type == "cuda" else "cpu")
        b_dev = device_batch(shape, mesh_size(mesh, data_axes(mesh)))
        within = axes_within_node(dict(zip(mesh.mesh_dim_names,
                                           mesh.shape)))
        step, args = build_step(cfg, shape, mesh, dev, b_dev)
        build_s = time.perf_counter() - t0
        tr = run_traced(step, args)
        del step, args
    rl = Roofline(flops_per_device=tr["flops"],
                  hbm_bytes_per_device=tr["bytes"],
                  collective_bytes_per_device=tr["collective_bytes"],
                  chips=chips, model_flops_total=model_flops(cfg, shape))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips, "trace_device": dev.type,
        "per_device_batch": b_dev,
        "build_s": build_s, "trace_s": tr["trace_s"],
        "memory_analysis": tr["memory_analysis"],
        "ops": tr["ops"], "kernel_calls": tr["kernel_calls"],
        "kernel_flops": tr["kernel_flops"],
        "collectives": tr["collectives"],
        "roofline": rl.to_dict(), "constants": CARD,
        "axes_within_node": list(within),
        "essential_bytes_per_device": essential_bytes(cfg, shape, chips),
        "attn_score_bytes": tr["attn_score_bytes"],
        "convert_bytes": tr["convert_bytes"],
        "top_ops": tr["top_ops"],
        "departures": DEPARTURES,
        **({"card": tr["card"]} if "card" in tr else {}),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             dump_ops: bool = False, serve_bf16: bool = False,
             kv_quant: bool = False) -> Dict:
    """Trace one cell on the meta device and write its JSON (and with
    ``dump_ops`` every operation's bytes, FLOPs and calls beside it)."""
    rec = trace_cell(arch, shape_name, mesh_kind, serve_bf16=serve_bf16,
                     kv_quant=kv_quant)
    ops = rec.pop("top_ops")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    path.write_text(json.dumps(rec, indent=1))
    if dump_ops:
        (out_dir / f"{arch}__{shape_name}__{mesh_kind}.ops.txt").write_text(
            "".join(f"{b:.6g} bytes  {f:.6g} flops  {n} calls  {name}\n"
                    for b, name, f, n in ops))
    rl = rec["roofline"]
    print(f"[dryrun] OK {arch} x {shape_name} x {mesh_kind}: "
          f"build {rec['build_s']:.1f}s trace {rec['trace_s']:.1f}s "
          f"{rec['ops']} ops bottleneck={rl['bottleneck']} "
          f"t=({rl['t_compute_s']:.4f},{rl['t_memory_s']:.4f},"
          f"{rl['t_collective_s']:.4f})s -> {path.name}", flush=True)
    return rec


def _todo(mesh_kinds, force: bool, out_dir: Path):
    return [(arch, shape_name, mk) for arch, shape_name in cells()
            for mk in mesh_kinds
            if force or not (out_dir / f"{arch}__{shape_name}__{mk}.json"
                             ).exists()]


def sweep(mesh_kinds, force: bool, out_dir: Path, **opts) -> int:
    """Every applicable cell not yet written (all with ``force``): one
    mesh kind in this process, several in one child process each, run
    at once.  Returns 1, after listing them, if any cell failed."""
    if len(mesh_kinds) > 1:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", mk, "--out", str(out_dir)]
            + (["--force"] if force else [])
            + [f"--{k.replace('_', '-')}" for k, v in opts.items() if v])
            for mk in mesh_kinds]
        codes = [p.wait() for p in procs]
        bad = [mk for mk, c in zip(mesh_kinds, codes) if c]
        if bad:
            print(f"[dryrun] FAILED mesh kinds: {bad}")
            return 1
        print("[dryrun] sweep complete, all cells green")
        return 0
    todo = _todo(mesh_kinds, force, out_dir)
    print(f"[dryrun] {len(todo)} cells to run", flush=True)
    failures = []
    for i, (arch, shape_name, mk) in enumerate(todo):
        print(f"[dryrun] ({i + 1}/{len(todo)}) {arch} x {shape_name} x {mk}",
              flush=True)
        try:
            run_cell(arch, shape_name, mk, out_dir, **opts)
        except Exception:       # noqa: BLE001 — listed, then exit 1
            failures.append((arch, shape_name, mk))
            print(f"[dryrun] FAIL {arch} x {shape_name} x {mk}\n"
                  f"{traceback.format_exc()}", flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        return 1
    print("[dryrun] sweep complete, all cells green")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dump-ops", action="store_true",
                    help="write every operation's bytes, FLOPs and calls "
                         "beside each cell's JSON")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="store serving weights in bf16")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    opts = dict(dump_ops=args.dump_ops, serve_bf16=args.serve_bf16,
                kv_quant=args.kv_quant)
    if args.all:
        return sweep(mesh_kinds, args.force, out_dir, **opts)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    for mk in mesh_kinds:
        run_cell(args.arch, args.shape, mk, out_dir, **opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
