"""Gradient compression for bandwidth-constrained data parallelism — the
port of the JAX package's ``repro.distributed.compression``.

:func:`compress_with_error_feedback` is int8 quantisation in blocks of
1024 values, one absmax scale a block, with an error-feedback accumulator
(EF-SGD style), applied between backward and the optimizer inside
``train_step``; on one device it models the quantisation noise that a
compressed all-reduce would add.  Rounding is half to even
(``torch.round``), as ``jnp.round`` rounds.  The blocks are laid over
the JAX package's leaves: a block list's leaves of one name (``ln1`` of
every layer) are one stacked leaf there, quantised as one array whose
blocks and scales span the layers, so the port stacks them the same way
(``tree.jax_leaf``).  Every division is by a tensor: CUDA divides by a
Python scalar as a multiplication by its reciprocal, which is not the
correctly rounded quotient the CPU and the JAX package compute.

:func:`compressed_psum` is the reference's int8 all-reduce, over a
``torch.distributed`` process group (the JAX package runs it inside
``shard_map`` over a mesh axis): a MAX all-reduce of the per-block
absmax (the shared scales), an int32 SUM all-reduce of the int8 payload,
then dequantisation, each float32 operation in the reference's order so
that the result is bit-equal to it.  Its payload is int8 only nominally:
the SUM all-reduce carries it widened to int32, as the reference's
``psum`` does, so the bytes sent (``wire_bytes``' ``sent``) are a float32
all-reduce's plus the scales.  A backend that refuses either
collective on the tensors' device raises; nothing is staged through host
memory here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import jax_leaf, tree_paths, tree_unflatten

F32 = torch.float32
_BLOCK = 1024


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values [blocks, 1024] and their scales [blocks, 1]."""
    flat = g.to(F32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    amax = flat.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(flat / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _dequant_leaf(q, scale, shape, dtype) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)
    return flat[:shape.numel()].reshape(shape).to(dtype)


def quantize_dequantize(g: torch.Tensor) -> torch.Tensor:
    q, s = _quant_leaf(g)
    return _dequant_leaf(q, s, g.shape, g.dtype)


def compress_with_error_feedback(grads, ef) -> Tuple[Any, Any]:
    """g_hat = Q(g + ef);  ef' = (g + ef) - g_hat, one JAX leaf at a
    time."""
    paths = list(tree_paths(grads))
    errs = [e for _, e in tree_paths(ef)]
    groups: Dict[tuple, List[int]] = {}
    for i, (path, _) in enumerate(paths):
        groups.setdefault(jax_leaf(path), []).append(i)
    ghats, new_errs = [None] * len(paths), [None] * len(paths)
    for idx in groups.values():
        corrected = torch.stack([paths[i][1].to(F32) + errs[i] for i in idx])
        ghat = quantize_dequantize(corrected)
        for j, i in enumerate(idx):
            ghats[i] = ghat[j].to(paths[i][1].dtype)
            new_errs[i] = corrected[j] - ghat[j]
    return tree_unflatten(grads, ghats), tree_unflatten(grads, new_errs)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce of ``x`` over ``group`` (the default group when
    None): agree on shared per-block scales (MAX all-reduce, tiny), then
    an integer SUM all-reduce, then dequantise.

    Nominal payload: 1 B an element plus 4 B a 1024-block scale, against
    4 B an element; sent: 4 B an element (padded to whole blocks) plus
    the scales, since the reference's ``psum`` and this all-reduce both
    carry the int8 values widened to int32, so that a sum over the ranks
    cannot overflow."""
    flat = x.to(F32).reshape(-1)
    n = flat.shape[0]
    blocks = F.pad(flat, (0, (-n) % _BLOCK)).reshape(-1, _BLOCK)
    shared = blocks.abs().amax(dim=1, keepdim=True)
    dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)  # scales
    scale = torch.clamp(shared / torch.full_like(shared, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)  # payload
    out = (summed.to(F32) * scale).reshape(-1)[:n]
    return out.reshape(x.shape).to(x.dtype)


def wire_bytes(numel: int) -> dict:
    """Bytes of :func:`compressed_psum` over ``numel`` values: the nominal
    int8 payload and the float32 scales, the int32 buffer the SUM
    all-reduce carries, what the two all-reduces send (``sent``: that
    buffer plus the scales), and a float32 all-reduce's."""
    blocks = -(-numel // _BLOCK)
    return {"int8_payload": numel, "scales": 4 * blocks,
            "int32_buffer": 4 * blocks * _BLOCK,
            "sent": 4 * blocks * _BLOCK + 4 * blocks, "float32": 4 * numel}
