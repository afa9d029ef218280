"""AdamW, the warmup-cosine schedule and global-norm clipping — the port
of the JAX package's ``repro.optim.adamw``, written out in torch rather
than through ``torch.optim.AdamW`` (which orders the decay and the bias
correction otherwise).

The train state is a plain dict (checkpoint friendly):
  {"params": ..., "m": ..., "v": ..., "step": int32 scalar, "ef": optional}

``make_train_step(model, cfg)`` builds ``train_step(state, batch) ->
(new_state, metrics)``: gradients of ``model.loss`` by autograd
(``loss_and_grads``), optional int8 compression with error feedback
(``distributed.compression``), clipping, then every leaf's AdamW update in
float32.  The schedule is computed in float32 tensors, as JAX computes
it.

Weight decay follows the JAX leaf's rank (ROADMAP C-ref-9): the JAX
package decays a leaf when ``p.ndim >= 2`` (``src/repro/optim/adamw.py:81``)
and stacks every block's parameters along a leading layer axis, so there
every per-block vector (``ln1``, ``ln2``, ``A_log``, ``D``, ``dt_bias``,
``conv_b``, ``norm_w``, ...) is rank 2 and decayed, and only the top-level
vectors (``final_norm``, ``enc_norm``) are not.  The port keeps blocks in
per-block lists, so it decays a leaf of rank >= 2 or one that lies inside
a block list (``tree.STACKED``): the same leaves as the reference.

On a device mesh (``launch.train --mesh elastic``) the parameters, ``m``
and ``v`` are DTensors laid out by ``distributed.sharding.
param_shardings``; ``step`` and the batch are replicated, as the JAX
launcher passes them.  The gradients come back as DTensors in the
parameters' layout (``loss_and_grads``; the models gather the parameters
at their entry), and every AdamW update is elementwise, so it runs on
each rank's local shards.  ``global_norm`` is the norm of the full
tensors: each leaf's sum of squares over its local shard, one SUM
all-reduce of the sharded leaves' sums over their mesh dims' groups,
then the leaves' sums added in tree order — on a world of one rank the
single-device sums, bit for bit.  Compression (``int8_ef``) quantises
the full gradients, as the reference's blocks span whole leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, tensor_device
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.tree import (STACKED, tree_leaves, tree_map, tree_paths,
                              tree_unflatten)

F32 = torch.float32
TrainState = Dict[str, Any]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # gradient compression: "none" | "int8_ef" (quantize-dequantize with
    # error feedback; models bandwidth-compressed DP all-reduce)
    compression: str = "none"


def lr_at(cfg: OptConfig, step, device: DeviceLike = None) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor, on its device, or a number,
    on ``device``: ``cuda`` unless asked), in float32: linear warmup, then
    cosine decay to ``min_lr_frac * lr``."""
    dev = tensor_device(step, device)
    step = torch.as_tensor(step, device=dev).to(F32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _sumsq(leaf) -> torch.Tensor:
    return torch.sum(torch.square(shd.local(leaf).to(F32)))


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf's full tensor (a plain tensor; DTensor
    leaves' local sums are summed over their sharding mesh dims)."""
    leaves = tree_leaves(tree)
    sums = [_sumsq(leaf) for leaf in leaves]
    groups: Dict[tuple, list] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            dims = tuple(j for j, _ in shd._sharded(mesh, leaf.placements))
            if dims:
                groups.setdefault((id(mesh), dims), []).append(i)
    for (_, dims), idx in groups.items():
        mesh = leaves[idx[0]].device_mesh
        part = torch.stack([sums[i] for i in idx])
        for j in dims:
            dist.all_reduce(part, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(j))
        for i, v in zip(idx, part):
            sums[i] = v
    return torch.sqrt(sum(sums))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda leaf: shd.like(
        leaf, (shd.local(leaf).to(F32) * scale).to(leaf.dtype)), tree), g


def init_train_state(params, cfg: OptConfig) -> TrainState:
    """Zero moments (float32) beside ``params``, step 0 (int32) on the
    parameters' device."""
    def zeros(p):
        return shd.like(p, torch.zeros(shd.local(p).shape, dtype=F32,
                                       device=p.device))
    state = {
        "params": params,
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=shd.local(tree_leaves(params)[0]).device),
    }
    if cfg.compression == "int8_ef":
        state["ef"] = tree_map(zeros, params)
    return state


def decays(path, p) -> bool:
    """Whether the JAX package decays the leaf ``p`` at ``path``: when its
    rank there is >= 2, which is the port's rank, plus one when the leaf
    lies in a stacked block list (C-ref-9)."""
    return p.dim() >= 2 or path[0] in STACKED


def _adamw_leaf(p, g, m, v, lr, cfg: OptConfig, t, decay: bool):
    """One leaf's update on local tensors (a DTensor's local shard)."""
    g = g.to(F32)
    pf = p.to(F32)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mh = m / (1 - cfg.b1 ** t)
    vh = v / (1 - cfg.b2 ** t)
    upd = mh / (torch.sqrt(vh) + cfg.eps)
    if decay:  # decoupled weight decay
        upd = upd + cfg.weight_decay * pf
    return (pf - lr * upd).to(p.dtype), m, v


def loss_and_grads(model, params, batch):
    """((loss, metrics), grads) of ``model.loss(params, batch)``, grads
    in the tree of ``params`` (zeros for a leaf the loss does not use, as
    JAX gives); everything returned is detached."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [shd.like(p, torch.zeros_like(shd.local(p))) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


@torch.no_grad()
def apply_updates(state: TrainState, grads, cfg: OptConfig
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step of ``state`` with ``grads``: (new state,
    {"grad_norm", "lr"})."""
    new_ef = None
    if cfg.compression == "int8_ef":
        full, ef = shd.unshard(grads), shd.unshard(state["ef"])
        full, ef = comp.compress_with_error_feedback(full, ef)
        grads = tree_map(_relayout, grads, full)
        new_ef = tree_map(_relayout, state["ef"], ef)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    t = (state["step"] + 1).to(F32)
    lr = lr_at(cfg, state["step"] + 1)
    out = [_adamw_leaf(shd.local(p), shd.local(g), shd.local(m),
                       shd.local(v), lr, cfg, t, decays(path, p))
           for (path, p), g, m, v in zip(tree_paths(state["params"]),
                                         tree_leaves(grads),
                                         tree_leaves(state["m"]),
                                         tree_leaves(state["v"]))]
    like = state["params"]

    def tree(i, refs):
        return tree_unflatten(like, [shd.like(r, o[i])
                                     for r, o in zip(tree_leaves(refs), out)])
    new_state = {
        "params": tree(0, like),
        "m": tree(1, state["m"]),
        "v": tree(2, state["v"]),
        "step": state["step"] + 1,
    }
    if new_ef is not None:
        new_state["ef"] = new_ef
    return new_state, {"grad_norm": gnorm, "lr": lr}


def _relayout(ref, full_t):
    """``full_t`` laid out as ``ref``: its local slice, as a DTensor."""
    if not isinstance(ref, DTensor):
        return full_t
    return shd.like(ref, shd.local_slice(full_t, ref.device_mesh,
                                         ref.placements))


def make_train_step(model, cfg: OptConfig
                    ) -> Callable[[TrainState, Any],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (new_state, metrics)``: the model's
    metrics plus ``grad_norm`` (before clipping) and ``lr``."""
    def train_step(state: TrainState, batch):
        (_, metrics), grads = loss_and_grads(model, state["params"], batch)
        new_state, opt_metrics = apply_updates(state, grads, cfg)
        return new_state, {**metrics, **opt_metrics}

    return train_step
