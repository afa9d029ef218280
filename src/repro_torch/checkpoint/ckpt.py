"""Fault-tolerant checkpointing: atomic and asynchronous — the port of the
JAX package's ``repro.checkpoint.ckpt``, in its layout.

Layout:  <dir>/step_<N>/
            manifest.json   (step, time, every leaf's shape and dtype)
            arrays.npz      (flattened leaf name -> ndarray)

A leaf's name is its path joined by ``::``, list indices as path parts
(``params::layers::0::attn::wq``).  NumPy has no bfloat16: such a leaf is
stored as its ``uint16`` bit pattern with ``"bfloat16"`` in the manifest,
and restored exactly.

  * ATOMIC commit — writes land in ``step_N.tmp`` and are ``os.rename``d
    (a preempted writer never leaves a half-readable checkpoint).
  * ASYNC save — the device->host copy happens synchronously, before the
    writer thread starts (so the next step cannot overwrite a buffer that
    is being written); the disk write runs on a background thread.
  * GC — keep the newest ``keep`` checkpoints.

On a device mesh (``launch.train --mesh elastic``) the state's leaves are
DTensors (or ZeRO-1 blocks, ``sharding.BlockShard``): ``save`` writes
their full arrays (each gathered by all-gathers over its sharding mesh
dims' groups, a block broadcast from its owner, so every rank calls it)
from rank 0 only, in the same layout, and ``restore(..., mesh=,
shardings=)`` lays each leaf out onto the target mesh
(``sharding.lay_out``, every rank keeping its own slice), whatever mesh
saved it — the elastic restart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import full, lay_out
from repro_torch.tree import tree_map_with_path, tree_paths

_SEP = "::"
_BF16 = "bfloat16"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of ``leaf`` on the host (synchronous; a copy on the CPU too,
    so that a later in-place update cannot reach the writer), bfloat16 as
    its uint16 bit pattern."""
    t = full(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(state) -> Dict[str, tuple]:
    """{name: (host array, dtype name)} of every leaf."""
    out = {}
    for path, leaf in tree_paths(state):
        arr = _to_host(leaf)
        name = _BF16 if leaf.dtype == torch.bfloat16 else str(arr.dtype)
        out[_key(path)] = (arr, name)
    return out


def save(state, ckpt_dir, step: int, *, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Checkpoint ``state`` (a tree of tensors or DTensors) at ``step``.
    Returns the writer thread if async.  In a process world every rank
    calls it (DTensors are gathered) and rank 0 alone writes."""
    ckpt_dir = Path(ckpt_dir)
    flat = _flatten(state)  # device->host happens HERE, synchronously
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(a.shape), "dtype": name}
                       for k, (a, name) in flat.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> List[int]:
    p = Path(ckpt_dir)
    if not p.exists():
        return []
    out = []
    for d in p.iterdir():
        if d.is_dir() and d.name.startswith("step_") and \
                not d.name.endswith(".tmp") and (d / "manifest.json").exists():
            out.append(int(d.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, like, step: Optional[int] = None,
            device: DeviceLike = None, *, mesh=None, shardings=None) -> Any:
    """The checkpoint at ``step`` (the latest when None) in the structure
    of ``like`` — a tree whose leaves have a ``dtype`` (tensors, meta
    tensors included) — each leaf cast to its ``like`` leaf's dtype and
    placed on ``device`` (``cuda`` unless asked; raises without a GPU).

    ``shardings`` (with ``mesh``): a tree of the same structure whose
    leaves are DTensor placement lists (or ZeRO-1 ``BlockPlacement``s,
    ``launch.specs.to_placements``), or None for a leaf kept whole; each
    such leaf is laid out onto ``mesh`` (``sharding.lay_out``) — the
    elastic restart onto a mesh other than the one that saved."""
    if (mesh is None) != (shardings is None):
        raise ValueError("restore: pass mesh and shardings together")
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    with np.load(d / "arrays.npz") as data:
        def leaf(path, want):
            key = _key(path)
            arr = data[key]
            if leaves[key]["dtype"] == _BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, "
                                 f"expected {tuple(want.shape)}")
            return t.to(device=dev, dtype=want.dtype)
        state = tree_map_with_path(leaf, like)
    if shardings is None:
        return state
    return tree_map_with_path(
        lambda _, t, pl: t if pl is None else lay_out(t, mesh, pl),
        state, shardings)


class CheckpointManager:
    """Train-loop-facing wrapper: periodic + preemption saves, async by
    default, waits for the in-flight write before starting another."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3,
                 async_: bool = True):
        self.ckpt_dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self.async_ = async_
        self._inflight: Optional[threading.Thread] = None

    def maybe_save(self, state, step: int, *, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()
        self._inflight = save(state, self.ckpt_dir, step, keep=self.keep,
                              async_=self.async_)
        return True

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
