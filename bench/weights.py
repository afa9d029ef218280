"""Random weights from the run's seed, drawn on the device in a few large
calls, in the parameter layout the program takes.

The layout (leaf names, shapes, types) comes from the program's meta-device
parameters, which hold no values.  The values are the benchmark's own: one
uniform draw over every matrix, turned into a normal truncated at +-2 in
place and scaled by 1/sqrt(fan-in) (the embedding by 0.02), and one draw
for the Mamba2 heads' decay (``A_log``) and step (``dt_bias``), as the
Mamba2 paper initialises them; ``D`` is one and norms and biases are zero.
Every leaf is a view into one buffer of its type.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch

F32 = torch.float32
SQRT2 = math.sqrt(2.0)


def _leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, fill: Callable, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fill, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fill, path + (i,))
                          for i, v in enumerate(tree))
    return fill(path, tree)


def _matrix(path, leaf) -> bool:
    return leaf.dim() >= 2


def _scale(path, leaf) -> float:
    return 0.02 if path[-1] == "embed" else 1.0 / math.sqrt(leaf.shape[-2])


def draw(layout, seed: int, device) -> Any:
    """A tree shaped as ``layout`` (meta tensors) with values drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    leaves = _leaves(layout)
    mats = [(p, t) for p, t in leaves if _matrix(p, t)]
    heads = [(p, t) for p, t in leaves if p[-1] in ("A_log", "dt_bias")]
    lo = 0.5 * (1.0 + math.erf(-2.0 / SQRT2))       # Phi(-2)
    buf = torch.rand(sum(t.numel() for _, t in mats), generator=gen,
                     dtype=F32, device=device)
    buf.mul_(1.0 - 2.0 * lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_() \
        .mul_(SQRT2)
    uni = torch.rand(sum(t.numel() for _, t in heads), generator=gen,
                     dtype=F32, device=device)
    views, at, hat = {}, 0, 0
    for p, t in mats:
        views[p] = buf[at: at + t.numel()].view(t.shape).mul_(_scale(p, t))
        at += t.numel()
    lo_dt, hi_dt = math.log(1e-3), math.log(1e-1)
    for p, t in heads:
        u = uni[hat: hat + t.numel()].view(t.shape)
        hat += t.numel()
        if p[-1] == "A_log":
            views[p] = torch.log(u * 15.0 + 1.0)
        else:       # softplus(dt_bias) = exp(U[log 1e-3, log 1e-1])
            views[p] = torch.log(torch.expm1(torch.exp(
                u * (hi_dt - lo_dt) + lo_dt)))

    def fill(path, leaf):
        v = views.get(path)
        if v is None:
            v = (torch.ones if path[-1] == "D" else torch.zeros)(
                leaf.shape, dtype=F32, device=device)
        return v.to(leaf.dtype)

    return _rebuild(layout, fill)
