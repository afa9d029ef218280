"""Per-(arch, shape, mesh) sharding specs for the dry run — the port of
the JAX package's ``repro.launch.specs``.

Each function returns the reference's ``PartitionSpec``s letter for
letter, as tuples of axis names (an entry None, a name, or a tuple of
names; ``distributed.sharding``'s convention), over the JAX package's
leaves: a per-block leaf of the port carries the spec of the stacked JAX
leaf that holds it.  :func:`to_placements` turns a tree of them into
DTensor placements for the port's own tensors.

What the port's step does with them (``launch.dryrun``, and any caller
that lays its inputs out by :func:`lay_out`, as ``jax.jit(in_shardings=
...)`` does): the parameters follow the TP rules; AdamW's moments and
error feedback take the ZeRO-1 specs of :func:`state_shardings` (a fold
onto a block list's block axis held as per-block entries that only the
owning data ranks hold, ``distributed.sharding.BlockShard``); a batch
cut over the data axes makes the step data-parallel (``optim.
make_train_step``: each rank's rows, the gradient summed over the data
groups); the decode cache's KV sequence is cut as :func:`cache_shardings`
says and the decode attention reduces its statistics and outputs over
those groups (``models.layers.attention_decode``); parameters laid out by
``distributed.sharding.param_shardings`` make ``prefill`` and
``decode_step`` tensor-parallel over ``model`` (``distributed.tp``), the
SSM decode state holding the rank's heads and the conv cache its
channels, as :func:`cache_shardings` lays them out.  The train step
still gathers its parameters at entry (ROADMAP A8 6b, training TP).
"""
from __future__ import annotations

from typing import Any, Dict

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (MeshRules, block_placement,
                                              distribute, local_spec,
                                              param_pspecs, placements,
                                              zero1_pspecs)
from repro_torch.launch.mesh import data_axes
from repro_torch.tree import STACKED, tree_map_with_path

Spec = tuple


def _dp(mesh: DeviceMesh):
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


def _axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def state_shardings(mesh: DeviceMesh, cfg: ModelConfig, state) -> Dict:
    """Train-state specs: ``params`` follow the TP rules; the optimizer
    states (``m``/``v``/``ef``) additionally shard over the data axes
    (ZeRO-1); ``step`` is replicated."""
    sizes, daxes = _axis_sizes(mesh), data_axes(mesh)
    out = {}
    for key, sub in state.items():
        if key == "step":
            out[key] = ()
        elif key in ("m", "v", "ef"):
            out[key] = zero1_pspecs(sub, cfg.tie_embeddings, sizes, daxes)
        else:
            out[key] = param_pspecs(sub, cfg.tie_embeddings, sizes)
    return out


def batch_shardings(mesh: DeviceMesh, cfg: ModelConfig, batch) -> Dict:
    """Every batch input sharded on its batch dim over the data axes
    (``patch_embeds``/``frames`` are rank 3)."""
    dp = _dp(mesh)
    return {k: (dp, None) if v.dim() == 2 else (dp, None, None)
            for k, v in batch.items()}


def cache_shardings(mesh: DeviceMesh, cfg: ModelConfig, cache,
                    shape: ShapeConfig) -> Dict:
    """Decode caches: KV caches shard the sequence dim on ``model`` and
    the batch on the data axes; at B = 1 (long_500k) the sequence spreads
    over every mesh axis and SSM states shard their heads on ``model``;
    ``len`` is replicated."""
    dp = _dp(mesh)
    single_seq = shape.global_batch == 1
    all_axes = tuple(mesh.mesh_dim_names)

    def spec(name: str) -> Spec:
        if name in ("k", "v", "ck", "cv"):        # [L, B, S, Hkv, Dh]
            if single_seq:
                return (None, None, all_axes, None, None)
            return (None, dp, "model", None, None)
        if name in ("k_s", "v_s"):                # int8-KV scales [L, B, S, Hkv]
            if single_seq:
                return (None, None, all_axes, None)
            return (None, dp, "model", None)
        if name == "state":                       # [L, B, H, Pd, N]
            return (None, None if single_seq else dp, "model", None, None)
        if name == "conv":                        # [L, B, W-1, conv_dim]
            return (None, None if single_seq else dp, None, "model")
        return ()                                 # len

    return {name: spec(name) for name in cache}


def token_shardings(mesh: DeviceMesh, shape: ShapeConfig) -> Spec:
    return (_dp(mesh),) if shape.global_batch > 1 else ()


def make_rules(mesh: DeviceMesh, cfg: ModelConfig) -> MeshRules:
    return MeshRules(mesh=mesh, data_axes=data_axes(mesh),
                     seq_parallel=cfg.seq_parallel)


def to_placements(mesh: DeviceMesh, specs) -> Any:
    """The layouts of a tree of specs over the port's leaves: DTensor
    placements (a per-block leaf drops its JAX leaf's block axis), or a
    :class:`~repro_torch.distributed.sharding.BlockPlacement` where a
    ZeRO-1 spec folds the data axes onto that block axis.  A train
    state's specs (``state_shardings``') are taken one sub-tree at a
    time, each over the parameters' paths."""
    if isinstance(specs, dict) and "params" in specs:
        return {k: to_placements(mesh, v) for k, v in specs.items()}

    def one(path, spec):
        if path and path[0] in STACKED and spec and spec[0] is not None:
            return block_placement(mesh, spec, path[1],
                                   len(specs[path[0]]))
        return placements(local_spec(path, spec), mesh)
    return tree_map_with_path(one, specs)


def lay_out(tree, mesh: DeviceMesh, specs):
    """A host tree (a train state, a batch, a decode cache, the tokens:
    the same full tensors on every rank) laid out by a tree of ``specs``
    of the same structure: each rank keeps its slice, nothing is sent
    (``distributed.sharding.distribute``); a leaf that is not a tensor
    (``len``) stays as it is, and a DTensor already laid out so (a
    tensor-parallel prefill's SSM state) too; a DTensor laid out
    otherwise is refused."""
    return distribute(tree, mesh, to_placements(mesh, specs))
