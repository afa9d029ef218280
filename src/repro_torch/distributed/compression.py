"""Gradient compression for bandwidth-constrained data parallelism — the
port of the JAX package's ``repro.distributed.compression`` (its
per-device part).

:func:`compress_with_error_feedback` is int8 quantisation in blocks of
1024 values, one absmax scale a block, with an error-feedback accumulator
(EF-SGD style), applied between backward and the optimizer inside
``train_step``; on one device it models the quantisation noise that a
compressed all-reduce would add.  Rounding is half to even
(``torch.round``), as ``jnp.round`` rounds.  The blocks are laid over
the JAX package's leaves: a block list's leaves of one name (``ln1`` of
every layer) are one stacked leaf there, quantised as one array whose
blocks and scales span the layers, so the port stacks them the same way
(``tree.jax_leaf``).  ``compressed_psum``, the
collective that shrinks the bytes on the wire, waits for the device mesh
(ROADMAP A8 item 6).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import jax_leaf, tree_paths, tree_unflatten

F32 = torch.float32
_BLOCK = 1024


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values [blocks, 1024] and their scales [blocks, 1]."""
    flat = g.to(F32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
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
