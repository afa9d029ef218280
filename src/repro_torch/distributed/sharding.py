"""Sharding rules: logical parameter axes -> mesh placements —
the port of the JAX package's ``repro.distributed.sharding``.

Layout (Megatron-style TP on the ``model`` axis, DP over ``data`` and the
multi-pod ``pod`` axis):

  * attention / MLP in-projections  : output dim on ``model``
  * attention / MLP out-projections : input dim on ``model``
  * MoE expert weights              : expert dim on ``model`` (EP)
  * Mamba2 projections              : inner dim / heads on ``model``
  * embeddings                      : hidden dim on ``model`` (untied) or
                                      vocab on ``model`` (tied, small tables)

The rule tables are the reference's letter for letter and produce its
PartitionSpecs, as tuples of axis names (an entry None, a name, or a
tuple of names), over the JAX package's leaves: the port keeps blocks in
per-block lists where JAX stacks them along a leading axis, so a spec is
computed on the JAX leaf (``tree.jax_leaf``, its shape with the block
count in front) and a per-block tensor takes it without that leading
entry.  :func:`placements` turns a spec into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dimension), :func:`distribute`
lays a tree out.

How the models run on sharded parameters.  ``loss`` (the train step),
``prefill`` and ``decode_step`` compute tensor-parallel over ``model``
on the parameters' shards, as the reference's GSPMD partitions the
products from these specs (``distributed.tp``, whose collectives carry
their backward, and which lays the residual out sequence-parallel where
the reference's ``shard_activation`` does).  ``forward`` (full logits,
for tests) computes on plain tensors: :func:`unshard` gathers each
DTensor parameter at its entry (Shard -> Replicate by all-gathers over
the mesh dims' process groups, whose backward is the local slice of the
gradient); checkpoints and ``int8_ef`` gather with it too.  What the
reference runs under ``shard_map`` is divided on every path: MoE expert
parallelism (``models.layers._moe_shardmap``), whose expert weights
stay sharded (``unshard(params, keep=is_moe_expert)`` in ``forward``);
``moe_constraint`` has no counterpart.
Parameters, AdamW's moments and the update are sharded as the rules say.
:class:`MeshRules` installed by :func:`activation_rules` turn expert
parallelism on; the launcher installs none, as the reference's does.
The data axes are divided where the reference divides them: a batch laid
out over them (:func:`batch_dims`) makes ``optim.make_train_step``
data-parallel (each rank's rows, the gradient summed over the data
groups, ZeRO-1 moments; ``MeshRules.local_batch`` tells the MoE path that
its activations are already a rank's rows, :func:`local_batch`), and a
decode cache laid out by ``launch.specs.cache_shardings`` cuts the KV
sequence (``models.layers.attention_decode``).

DTensors are the containers (placements, the local shard); every
collective is an explicit ``torch.distributed`` call over a mesh dim's
group (:func:`gather`, :func:`scatter`, :func:`sum_grad`,
:func:`gather_local`, :func:`reduce_scatter_dims`), never DTensor's own
redistribution, which fails over gloo on CUDA tensors where the
process-group calls work.

ZeRO-1 on per-block leaves.  :func:`zero1_pspecs` folds the data axes
onto the first free, divisible dim of the JAX leaf, its block axis
included: at ``data = 2`` with 2 layers ``layers/attn/wq``'s moments go
``("data", None, "model")``, data rank 0 owning block 0 and data rank 1
block 1.  The port keeps one tensor a block, so such a leaf is held as
per-block entries that a rank holds only for the blocks it owns
(:class:`BlockShard`, laid out by a :class:`BlockPlacement`): an owned
block is the whole block laid out over the other mesh dims as the spec's
remaining entries say, every other block an empty tensor.  A rank's
owned blocks stacked are the reference's ``NamedSharding.shard_shape``
of the JAX leaf; a fold onto any other dim is a DTensor ``Shard`` of the
per-block tensor.  The tree keeps the parameters' containers, so a
ZeRO-1 state saves and restores through the same checkpoint layout as
any other (``full`` gathers a block from its owner).
"""
from __future__ import annotations

import dataclasses
import re
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.tree import (STACKED, jax_leaf, tree_leaves,
                              tree_map_with_path)

Spec = Tuple  # entries: None, an axis name, or a tuple of axis names


@dataclass
class MeshRules:
    mesh: DeviceMesh
    data_axes: Tuple[str, ...]  # ("data",) or ("pod", "data")
    model_axis: str = "model"
    seq_parallel: bool = True
    #: the activations hold this rank's rows of a batch sharded over the
    #: data axes (a data-parallel step), not the whole replicated batch
    local_batch: bool = False

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


_CURRENT: Optional[MeshRules] = None


@contextmanager
def activation_rules(rules: Optional[MeshRules]):
    global _CURRENT
    prev, _CURRENT = _CURRENT, rules
    try:
        yield
    finally:
        _CURRENT = prev


def current_rules() -> Optional[MeshRules]:
    return _CURRENT


@contextmanager
def local_batch():
    """While open, the installed rules (if any) say that the activations
    hold this rank's rows of a batch cut over the data axes."""
    rules = _CURRENT
    with activation_rules(None if rules is None else
                          dataclasses.replace(rules, local_batch=True)):
        yield


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_size(mesh: DeviceMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return axis_size(mesh, axes)
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(i)`` where entry i names it (alone or in a tuple), else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter specs (path-based rules)
# ---------------------------------------------------------------------------

# leaf-name -> (rule). Axis entries are applied right-aligned to the leaf
# rank so the same rule covers stacked ([L, ...]) and unstacked tensors.
_PARAM_RULES = [
    (r"embed$", ("model_if_tied", "model_if_untied")),
    (r"unembed$", (None, "model")),
    (r"(patch_proj|frame_proj)$", (None, None)),
    (r"(wq|wk|wv|wg|wi)$", (None, "model")),          # in-projections [.., d, out]
    (r"wo$", ("model", None)),                        # out-projections [.., in, d]
    (r"router$", (None, None)),
    (r"in_proj$", (None, "model")),
    (r"out_proj$", ("model", None)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(A_log|D|dt_bias)$", ("model",)),
    (r"norm_w$", ("model",)),
    (r"(ln1|ln2|ln3|final_norm)$", (None,)),
]

# MoE expert tensors are 4-D stacked [L, E, d, f]: shard experts (dim 1).
_MOE_EXPERT_RE = re.compile(r"moe.*(wg|wi|wo)$")


def path_str(path) -> str:
    """The JAX package's leaf path string of the port's leaf at ``path``
    (``layers/attn/wq`` for ``("layers", 3, "attn", "wq")``)."""
    return "/".join(str(p) for p in jax_leaf(tuple(path)))


def is_moe_expert(path) -> bool:
    return bool(_MOE_EXPERT_RE.search(path_str(path)))


def jax_shape(tree, path, leaf) -> tuple:
    """The shape of the JAX leaf holding ``leaf``: a block list's leaf has
    the block count in front."""
    shape = tuple(leaf.shape)
    if path and path[0] in STACKED:
        return (len(tree[path[0]]),) + shape
    return shape


def _validate(spec, shape, axis_sizes):
    """Drop axis assignments whose dim isn't divisible."""
    if axis_sizes is None:
        return tuple(spec)
    out = []
    for i, a in enumerate(spec):
        if a is not None and shape[i] % axis_sizes.get(a, 1) != 0:
            out.append(None)
        else:
            out.append(a)
    return tuple(out)


def spec_for_param(path_str: str, shape, tied: bool, axis_sizes=None) -> Spec:
    ndim = len(shape)
    if _MOE_EXPERT_RE.search(path_str):
        # [L, E, d, f] or [E, d, f]: shard experts (EP); if the expert count
        # doesn't divide the model axis (e.g. 40 experts on 16 shards),
        # fall back to TP inside each expert (dim -2: d for wg/wi, f for wo).
        spec = [None] * ndim
        e_dim, inner_dim = ndim - 3, ndim - 2
        msize = (axis_sizes or {}).get("model", 1)
        if shape[e_dim] % msize == 0:
            spec[e_dim] = "model"
        elif shape[inner_dim] % msize == 0:
            spec[inner_dim] = "model"
        return tuple(spec)
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path_str):
            if rule == ("model_if_tied", "model_if_untied"):
                spec = ["model", None] if tied else [None, "model"]
                return _validate(spec, shape, axis_sizes)
            axes = list(rule)
            full = [None] * (ndim - len(axes)) + axes
            spec = full[:ndim] if ndim >= len(axes) else axes[-ndim:]
            return _validate(spec, shape, axis_sizes)
    return ()  # replicate by default


def param_pspecs(params, tied: bool = False, axis_sizes=None):
    """The JAX PartitionSpec (a tuple) of every leaf's JAX leaf, in the
    containers of ``params``."""
    return tree_map_with_path(
        lambda path, leaf: spec_for_param(path_str(path),
                                          jax_shape(params, path, leaf),
                                          tied, axis_sizes),
        params)


def local_spec(path, spec: Spec) -> Spec:
    """The spec of the port's tensor at ``path`` from its JAX leaf's: a
    per-block tensor drops the block axis, which no rule shards."""
    if path and path[0] in STACKED and spec:
        if spec[0] is not None:
            raise ValueError(f"{path_str(path)}: the block axis is sharded "
                             f"({spec}); per-block tensors cannot hold it")
        return tuple(spec[1:])
    return tuple(spec)


def param_shardings(mesh: DeviceMesh, params, tied: bool = False):
    """The placements of every leaf of ``params`` on ``mesh``."""
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    specs = param_pspecs(params, tied, axis_sizes)
    return tree_map_with_path(
        lambda path, spec: placements(local_spec(path, spec), mesh), specs)


def zero1_pspecs(params, tied: bool, axis_sizes, data_axes):
    """ZeRO-1: optimizer-state specs = param specs + the data axes folded
    onto the first free, divisible dim of the JAX leaf (its block axis
    included)."""
    base = param_pspecs(params, tied, axis_sizes)
    dsize = 1
    for a in data_axes:
        dsize *= axis_sizes.get(a, 1)
    dax = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]

    def upgrade(path, leaf, spec):
        shape = jax_shape(params, path, leaf)
        spec_l = list(spec) + [None] * (len(shape) - len(spec))
        for i, s in enumerate(spec_l):
            if s is None and shape[i] % dsize == 0 and shape[i] > 0:
                spec_l[i] = dax
                return tuple(spec_l)
        return tuple(spec_l)  # nothing divisible: keep replicated over data

    return tree_map_with_path(upgrade, params, base)


# ---------------------------------------------------------------------------
# laying trees out and gathering them back
# ---------------------------------------------------------------------------

def distribute(tree, mesh: DeviceMesh, shardings):
    """Every leaf of ``tree`` (the same full tensor on every rank) laid
    out by its entry of ``shardings`` (a tree of placement tuples,
    ``param_shardings``', or :class:`BlockPlacement`s): a DTensor, or a
    :class:`BlockShard`; each rank keeps its own slice, nothing is sent.
    A leaf that is not a tensor (a decode cache's ``len``) stays as it
    is."""
    return tree_map_with_path(lambda _, leaf, pl: lay_out(leaf, mesh, pl),
                              tree, shardings)


def lay_out(t, mesh: DeviceMesh, pl):
    """The full tensor ``t`` (on every rank) laid out by ``pl``: this
    rank's part, nothing sent.  A DTensor ``t`` laid out by ``pl``
    already (a tensor-parallel prefill's SSM state) stays as it is; one
    laid out otherwise is refused, as regathering it would hide both the
    cost and the disagreement."""
    if not isinstance(t, torch.Tensor):
        return t
    if isinstance(t, DTensor):
        if isinstance(pl, BlockPlacement) or t.device_mesh != mesh or \
                _sharded(mesh, t.placements) != _sharded(mesh, pl):
            raise ValueError(f"a DTensor laid out by {tuple(t.placements)} "
                             f"cannot be laid out by {pl}: lay it out so "
                             f"where it is computed")
        return t
    if isinstance(pl, BlockPlacement):
        # a storage of its own, as distribute_tensor gives a shard
        part = local_slice(t, mesh, pl.placements).clone()
        if data_index(mesh, pl.data_dims) != pl.owner:
            part = part.new_empty((0,) + tuple(part.shape[1:]))
        return BlockShard(part, mesh, pl, t.shape)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


# ---------------------------------------------------------------------------
# ZeRO-1 blocks: a block list's leaf whose data axes fold onto the block axis
# ---------------------------------------------------------------------------

class BlockPlacement(NamedTuple):
    """The layout of one block of a JAX leaf whose spec puts the data axes
    on its block axis: the data rank ``owner`` (the flat index over the
    mesh dims ``data_dims``, the first major) holds the block, laid out
    over the mesh by ``placements`` (``Replicate`` on ``data_dims``);
    every other data rank holds an empty tensor."""
    owner: int
    data_dims: Tuple[int, ...]
    placements: tuple


def block_placement(mesh: DeviceMesh, spec: Spec, block: int,
                    n_blocks: int) -> BlockPlacement:
    """Block ``block`` of ``n_blocks`` under the JAX leaf's ``spec``, whose
    first entry (the data axes) shards the block axis: contiguous runs of
    ``n_blocks / parts`` blocks a data rank."""
    axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    dims = tuple(mesh.mesh_dim_names.index(a) for a in axes)
    parts = 1
    for i in dims:
        parts *= mesh.size(i)
    return BlockPlacement(block // (n_blocks // parts), dims,
                          placements(tuple(spec[1:]), mesh))


def data_index(mesh: DeviceMesh, dims) -> int:
    """This rank's flat index over the mesh dims ``dims`` (the first
    major), as JAX orders a tuple of axes."""
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


class BlockShard:
    """One block of a ZeRO-1 leaf folded over the block axis
    (:class:`BlockPlacement`): the DTensor-like holder of this rank's
    part — the owned block's local shard, or an empty tensor (its first
    dim 0) on every other data rank.  ``shape`` is the whole block's."""

    def __init__(self, part: torch.Tensor, mesh: DeviceMesh,
                 layout: BlockPlacement, shape):
        self._local_tensor = part
        self.device_mesh = mesh
        self.layout = layout
        self.shape = torch.Size(shape)

    @property
    def owned(self) -> bool:
        return data_index(self.device_mesh, self.layout.data_dims) == \
            self.layout.owner

    @property
    def dtype(self) -> torch.dtype:
        return self._local_tensor.dtype

    def to_local(self) -> torch.Tensor:
        return self._local_tensor

    def full(self) -> torch.Tensor:
        """The whole block on every rank: the owner's part broadcast over
        each data dim's group (the last first), then gathered over the
        mesh dims that shard it."""
        mesh, lay = self.device_mesh, self.layout
        t = self._local_tensor
        if not self.owned:
            shape = local_slice(torch.empty(self.shape, device="meta"),
                                mesh, lay.placements).shape
            t = t.new_empty(shape)
        owner, coords = lay.owner, []
        for i in reversed(lay.data_dims):
            owner, c = divmod(owner, mesh.size(i))
            coords.append((i, c))
        for i, c in coords:
            if mesh.size(i) > 1:
                group = mesh.get_group(i)
                dist.broadcast(t, src=dist.get_global_rank(group, c),
                               group=group)
        return gather_local(t, mesh, lay.placements)


def _sharded(mesh: DeviceMesh, pl) -> list:
    """(mesh dim, tensor dim) of every ``Shard`` placement over more than
    one rank, in mesh-dim order."""
    return [(i, p.dim) for i, p in enumerate(pl)
            if isinstance(p, Shard) and mesh.size(i) > 1]


def local_slice(x: torch.Tensor, mesh: DeviceMesh, pl) -> torch.Tensor:
    """This rank's part of the full tensor ``x`` under placements ``pl``
    (even shards; a mesh dim's chunks in rank order)."""
    for i, d in _sharded(mesh, pl):
        n = mesh.size(i)
        size = x.shape[d] // n
        x = x.narrow(d, mesh.get_local_rank(i) * size, size)
    return x.contiguous()


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along ``dim``, in
    rank order (``all_gather_into_tensor``)."""
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim).contiguous()


def gather_local(t: torch.Tensor, mesh: DeviceMesh, pl) -> torch.Tensor:
    """The full tensor of this rank's part ``t`` under placements ``pl``:
    one all-gather over each sharding mesh dim's group, the last mesh dim
    first."""
    for i, d in reversed(_sharded(mesh, pl)):
        t = all_gather_dim(t, d, mesh.get_group(i), mesh.size(i))
    return t


class _Gather(torch.autograd.Function):
    """Shard -> Replicate: the full tensor; backward the local slice (every
    rank computes the same replicated gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return gather_local(t, mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.mesh, ctx.pl), None, None


class _Scatter(torch.autograd.Function):
    """Replicate -> Shard: this rank's slice; backward the all-gather of
    every rank's slice gradient."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return local_slice(x, mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return gather_local(g.contiguous(), ctx.mesh, ctx.pl), None, None


class _SumGrad(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``groups`` (a tensor
    replicated over mesh dims whose ranks used it on different data)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group in ctx.groups:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None


def scatter(x: torch.Tensor, mesh: DeviceMesh, pl) -> torch.Tensor:
    """Replicated ``x`` -> this rank's block under ``pl`` (differentiable:
    the backward all-gathers)."""
    return _Scatter.apply(x, mesh, tuple(pl))


def gather(t: torch.Tensor, mesh: DeviceMesh, pl) -> torch.Tensor:
    """This rank's block ``t`` under ``pl`` -> the replicated full tensor
    (differentiable: the backward takes the local slice)."""
    return _Gather.apply(t, mesh, tuple(pl))


def sum_grad(x: torch.Tensor, mesh: DeviceMesh, dims) -> torch.Tensor:
    """``x`` whose gradient is summed over the mesh dims ``dims`` (names)
    in the backward."""
    groups = [mesh.get_group(a) for a in dims if axis_size(mesh, a) > 1]
    return _SumGrad.apply(x, groups) if groups else x


def full(x):
    """The full tensor of a DTensor (explicit all-gathers over its
    sharding mesh dims' groups; differentiable, its backward the local
    slice) or of a :class:`BlockShard` (not differentiable), a plain
    tensor as it is.  DTensor's own collectives are not used: over gloo
    on CUDA tensors they fail, where the process-group calls work."""
    if isinstance(x, BlockShard):
        return x.full()
    if not isinstance(x, DTensor):
        return x
    pl = tuple(x.placements)
    if not _sharded(x.device_mesh, pl):
        return x.to_local()
    return _Gather.apply(x.to_local(), x.device_mesh, pl)


def unshard(tree, keep: Optional[Callable] = None):
    """Every DTensor leaf of ``tree`` gathered to its full tensor, except
    those at a path where ``keep(path)`` holds (the models' entry keeps
    the MoE expert weights, which expert parallelism uses as local
    shards).  Plain leaves are returned as they are."""
    return tree_map_with_path(
        lambda path, x: x if keep is not None and keep(path) else full(x),
        tree)


def like(ref, local: torch.Tensor):
    """``local`` as a DTensor (or :class:`BlockShard`) laid out as ``ref``
    (a plain ``ref``: as it is)."""
    if isinstance(ref, BlockShard):
        return BlockShard(local, ref.device_mesh, ref.layout, ref.shape)
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def local(x) -> torch.Tensor:
    return x.to_local() if isinstance(x, (DTensor, BlockShard)) else x


def slice_as(ref, t: torch.Tensor):
    """The full tensor ``t`` laid out as ``ref`` (this rank's part; a
    plain ``ref``: ``t`` as it is)."""
    if isinstance(ref, BlockShard):
        return lay_out(t, ref.device_mesh, ref.layout)
    if isinstance(ref, DTensor):
        return like(ref, local_slice(t, ref.device_mesh, ref.placements))
    return t


def sum_dims(x) -> Tuple[int, ...]:
    """The mesh dims (of more than one rank) whose ranks hold different
    parts of ``x``: a sum over its local part, summed over them, counts
    every element once."""
    if isinstance(x, BlockShard):
        mesh = x.device_mesh
        dims = {i for i in x.layout.data_dims if mesh.size(i) > 1}
        dims |= {i for i, _ in _sharded(mesh, x.layout.placements)}
        return tuple(sorted(dims))
    if isinstance(x, DTensor):
        return tuple(i for i, _ in _sharded(x.device_mesh, x.placements))
    return ()


def batch_dims(tree) -> Tuple[str, ...]:
    """The names of the mesh dims over which a batch's DTensor leaves are
    cut along their batch dim (``Shard(0)``; ``launch.specs.
    batch_shardings``); empty for a plain or replicated batch."""
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            return tuple(n for n, p in zip(x.device_mesh.mesh_dim_names,
                                           x.placements)
                         if isinstance(p, Shard) and p.dim == 0)
    return ()


def reduce_scatter_dims(t: torch.Tensor, dim: int, mesh: DeviceMesh,
                        dims) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh dims ``dims``
    (indices), this rank's chunk of it along ``dim``: one
    ``reduce_scatter_tensor`` over each dim's group, in mesh order, so
    that the chunks fall as :func:`local_slice` cuts them (the first dim
    major)."""
    for i in dims:
        n = mesh.size(i)
        if n == 1:
            continue
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=mesh.get_group(i))
        t = out.movedim(0, dim)
    return t.contiguous()


def all_reduce_dims(t: torch.Tensor, mesh: DeviceMesh, dims,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the ranks of the mesh dims ``dims``
    (names or indices), one all-reduce a dim."""
    for a in dims:
        i = mesh.mesh_dim_names.index(a) if isinstance(a, str) else a
        if mesh.size(i) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


# ---------------------------------------------------------------------------
# sweep-grid cell sharding (launch.mesh.make_sweep_mesh's 1-D "cells" mesh)
# ---------------------------------------------------------------------------

def cells_sharding(mesh: DeviceMesh, axis: str = "cells") -> tuple:
    """Row sharding along the sweep mesh's cell axis."""
    return placements((axis,), mesh)


def replicate_to_mesh(x, mesh: DeviceMesh) -> DTensor:
    """``x`` (a tensor on this rank's device) fully replicated on
    ``mesh``: every rank holds all of it (the shared (pi, nu) view history
    of a sweep-grid table build)."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_cells(arrays: Sequence, mesh: DeviceMesh, axis_name: str = "cells",
                *, device=None):
    """Row-shard a list of cell-axis arrays over a 1-D sweep mesh.

    Every array's leading dim is the cell count; it is padded to a
    multiple of the mesh size by repeating the final row (redundant work
    on the last shard) and each rank keeps its rows, as DTensors with a
    :func:`cells_sharding`, on ``device`` (the rank's own; the CPU when
    None).  Returns ``(sharded_arrays, original_count)`` so callers can
    slice the padding back off."""
    pl = cells_sharding(mesh, axis_name)
    size = axis_size(mesh, axis_name)
    count = int(np.asarray(arrays[0]).shape[0])
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = (-a.shape[0]) % size
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        t = torch.as_tensor(a, device=device)
        out.append(distribute_tensor(t, mesh, pl, src_data_rank=None))
    return out, count
