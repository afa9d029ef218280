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
launcher passes them.  The models' ``loss`` computes tensor-parallel on
the parameters' shards (``distributed.tp``), so the gradients come back
as DTensors in the parameters' layout (``loss_and_grads``): a leaf cut
over ``model`` holds the gradient of its own part, a replicated leaf the
whole gradient, equal on every model rank (the collectives' backward
sums the ranks' parts where a rank computed on its block: the norms
under sequence parallelism, a tensor that rank-partial products read).
Every AdamW update is elementwise, so it runs on each rank's local
shards.  ``global_norm`` is the norm of the full tensors: each leaf's
sum of squares over its local shard, one SUM all-reduce of the cut
leaves' sums over their mesh dims' groups (a replicated leaf counted
once), then the leaves' sums added in tree order — on a world of one
rank the single-device sums, bit for bit.  Compression (``int8_ef``)
quantises the full gradients, as the reference's blocks span whole
leaves.

The data axes (the reference's ``jax.jit(step, in_shardings=(state_sh,
batch_sh))`` with ``launch.specs.state_shardings``/``batch_shardings``).
When the batch's leaves are DTensors cut along the batch over the data
axes (``sharding.batch_dims``; ``launch.specs.lay_out``), the step is
data-parallel:

  * each rank runs the model on its own rows, and the loss is the global
    masked mean: the token count is all-reduced over the data groups
    first, and each rank takes the gradient of its masked sum over that
    count (a mean of the ranks' means would weigh unequal masks wrongly);
    ``metrics["loss"]`` and ``metrics["tokens"]`` are the global values;
  * the gradient is summed over the data groups in float32, by explicit
    process-group calls: a reduce-scatter into the layout of ``m`` where
    the state is ZeRO-1 (its moments fold the data axes onto a dim; a fold
    onto a block list's block axis reduce-scatters the blocks stacked),
    an all-reduce where ``m`` is replicated over the data axes;
  * ``int8_ef`` then compresses the *reduced* gradient with error
    feedback, over the whole JAX leaf's blocks (gathered, as above), and
    lays the result and the new ``ef`` out as ``ef``;
  * ``global_norm`` sums each leaf's local squares over every mesh dim
    whose ranks hold different parts of it (a ZeRO-1 slice over the data
    dims too; a part replicated over them is counted once);
  * AdamW updates each rank's ZeRO-1 slice of the parameters, and the new
    slices are all-gathered over the data groups back to the parameters'
    layout.

A ZeRO-1 state with a replicated batch skips the reduction and updates
its slices the same way.  A replicated batch with moments in the
parameters' layout takes the path above unchanged.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import DeviceLike, tensor_device
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.tree import (STACKED, jax_leaf, tree_leaves, tree_map,
                              tree_paths, tree_unflatten)

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
    """The norm of every leaf's full tensor (a plain tensor; a DTensor's
    or ZeRO-1 block's local sums are summed over the mesh dims whose ranks
    hold different parts of it, ``sharding.sum_dims``)."""
    leaves = tree_leaves(tree)
    sums = [_sumsq(leaf) for leaf in leaves]
    groups: Dict[tuple, list] = {}
    for i, leaf in enumerate(leaves):
        dims = shd.sum_dims(leaf)
        if dims:
            groups.setdefault((id(leaf.device_mesh), dims), []).append(i)
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
    JAX gives); everything returned is detached.  A batch cut over the
    data axes (``sharding.batch_dims``) gives each rank's share of the
    gradient of the global masked mean, not yet summed over the data
    groups (``apply_updates`` sums it), and the global loss and token
    count."""
    dims = shd.batch_dims(batch)
    count, ctx = None, contextlib.nullcontext()
    if dims:
        ctx = shd.local_batch()
        mesh = next(x.device_mesh for x in tree_leaves(batch)
                    if isinstance(x, DTensor))
        batch = {k: shd.local(v) for k, v in batch.items()}
        mask = batch.get("mask")
        count = (mask.to(F32).sum() if mask is not None else
                 torch.full((), batch["labels"].numel(), dtype=F32,
                            device=batch["labels"].device))
        shd.all_reduce_dims(count, mesh, dims)
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    with torch.enable_grad(), ctx:
        tree = tree_unflatten(params, leaves)
        loss, metrics = (model.loss(tree, batch) if count is None else
                         model.loss(tree, batch, count=count))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [shd.like(p, torch.zeros_like(shd.local(p))) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    loss = loss.detach()
    if count is not None:
        loss = shd.all_reduce_dims(loss.clone(), mesh, dims)
        metrics.update(loss=loss, tokens=count)
    return (loss, metrics), tree_unflatten(params, grads)


def _fold(p, m) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(tensor dim, mesh dims) of the data axes that ``m``'s ZeRO-1 layout
    folds onto a dim of the per-block tensor where its parameter ``p`` is
    replicated; None when ``m`` is laid out like ``p`` over them (a block
    fold, :class:`~repro_torch.distributed.sharding.BlockShard`, is
    handled by the caller)."""
    if not (isinstance(p, DTensor) and isinstance(m, DTensor)):
        return None
    mesh = m.device_mesh
    dims = tuple(i for i, (a, b) in enumerate(zip(p.placements,
                                                  m.placements))
                 if a != b and mesh.size(i) > 1)
    return (m.placements[dims[0]].dim, dims) if dims else None


def _fold_pl(mesh, dim: int, dims) -> tuple:
    return tuple(Shard(dim) if i in dims else Replicate()
                 for i in range(mesh.ndim))


def _to_zero(paths, params, grads, moments, data_dims):
    """Each leaf's gradient in its moment's layout, as float32 local
    parts: summed over the data dims ``data_dims`` (names; a data-
    parallel step) — reduce-scattered onto a ZeRO-1 fold, all-reduced
    where the moment is replicated over them — or, without
    ``data_dims``, sliced to the fold."""
    out = [None] * len(paths)
    blocks: Dict[tuple, List[int]] = {}
    for i, (path, p, g, m) in enumerate(zip(paths, params, grads, moments)):
        if isinstance(m, shd.BlockShard):
            blocks.setdefault(jax_leaf(path), []).append(i)
            continue
        t = shd.local(g).to(F32)
        fold = _fold(p, m)
        if fold is None:
            out[i] = (shd.all_reduce_dims(t.clone(), p.device_mesh,
                                          data_dims)
                      if data_dims else t)
        elif data_dims:
            out[i] = shd.reduce_scatter_dims(t, fold[0], m.device_mesh,
                                             fold[1])
        else:
            out[i] = shd.local_slice(t, m.device_mesh,
                                     _fold_pl(m.device_mesh, *fold))
    for idx in blocks.values():
        m0 = moments[idx[0]]
        mesh, dims = m0.device_mesh, m0.layout.data_dims
        if data_dims:
            mine = shd.reduce_scatter_dims(
                torch.stack([shd.local(grads[i]).to(F32) for i in idx]), 0,
                mesh, dims)
        else:
            mine = [shd.local(grads[i]).to(F32) for i in idx
                    if moments[i].owned]
        owned = iter(mine)
        for i in idx:       # an empty part where another rank owns it
            out[i] = next(owned) if moments[i].owned else \
                shd.local(moments[i])
    return out


def _zero_slice(p, m) -> torch.Tensor:
    """This rank's part of parameter ``p`` in its moment ``m``'s layout."""
    t = shd.local(p)
    if isinstance(m, shd.BlockShard):
        return t if m.owned else t[:0]
    fold = _fold(p, m)
    if fold is None:
        return t
    return shd.local_slice(t, m.device_mesh, _fold_pl(m.device_mesh, *fold))


def _from_zero(paths, params, moments, parts) -> list:
    """The new parameters in their own layout from each rank's updated
    ZeRO-1 parts: all-gathered over the data dims of each fold (a block
    fold's owned blocks stacked)."""
    out = [None] * len(paths)
    blocks: Dict[tuple, List[int]] = {}
    for i, (path, p, m, t) in enumerate(zip(paths, params, moments, parts)):
        if isinstance(m, shd.BlockShard):
            blocks.setdefault(jax_leaf(path), []).append(i)
            continue
        fold = _fold(p, m)
        if fold is not None:
            t = shd.gather_local(t, m.device_mesh,
                                 _fold_pl(m.device_mesh, *fold))
        out[i] = shd.like(p, t)
    for idx in blocks.values():
        m0 = moments[idx[0]]
        mine = [parts[i] for i in idx if moments[i].owned]
        every = shd.gather_local(torch.stack(mine), m0.device_mesh, _fold_pl(
            m0.device_mesh, 0, m0.layout.data_dims))
        for j, i in enumerate(idx):
            out[i] = shd.like(params[i], every[j])
    return out


@torch.no_grad()
def apply_updates(state: TrainState, grads, cfg: OptConfig,
                  data_dims: Sequence[str] = ()
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step of ``state`` with ``grads``: (new state,
    {"grad_norm", "lr"}).  ``data_dims``: the mesh dims (names) a
    data-parallel batch was cut over — ``grads`` are this rank's share,
    summed over them here."""
    paths = [path for path, _ in tree_paths(state["params"])]
    params = tree_leaves(state["params"])
    moments = tree_leaves(state["m"])
    gl = tree_leaves(grads)
    parts = _to_zero(paths, params, gl, moments, tuple(data_dims))
    grads = tree_unflatten(state["m"], [
        shd.like(m, t.to(g.dtype)) for m, g, t in zip(moments, gl, parts)])
    new_ef = None
    if cfg.compression == "int8_ef":
        full, ef = shd.unshard(grads), shd.unshard(state["ef"])
        full, ef = comp.compress_with_error_feedback(full, ef)
        grads = tree_map(shd.slice_as, grads, full)
        new_ef = tree_map(shd.slice_as, state["ef"], ef)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = shd.local(state["step"])
    t = (step + 1).to(F32)
    lr = lr_at(cfg, step + 1)
    out = [_adamw_leaf(_zero_slice(p, m), shd.local(g), shd.local(m),
                       shd.local(v), lr, cfg, t, decays(path, p))
           for path, p, g, m, v in zip(paths, params, tree_leaves(grads),
                                       moments, tree_leaves(state["v"]))]

    def tree(i, refs):
        return tree_unflatten(refs, [shd.like(r, o[i])
                                     for r, o in zip(tree_leaves(refs), out)])
    new_state = {
        "params": tree_unflatten(state["params"], _from_zero(
            paths, params, moments, [o[0] for o in out])),
        "m": tree(1, state["m"]),
        "v": tree(2, state["v"]),
        "step": shd.like(state["step"], step + 1),
    }
    if new_ef is not None:
        new_state["ef"] = new_ef
    return new_state, {"grad_norm": gnorm, "lr": lr}


def make_train_step(model, cfg: OptConfig
                    ) -> Callable[[TrainState, Any],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (new_state, metrics)``: the model's
    metrics plus ``grad_norm`` (before clipping) and ``lr``."""
    def train_step(state: TrainState, batch):
        (_, metrics), grads = loss_and_grads(model, state["params"], batch)
        new_state, opt_metrics = apply_updates(state, grads, cfg,
                                               shd.batch_dims(batch))
        return new_state, {**metrics, **opt_metrics}

    return train_step
