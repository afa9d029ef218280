"""The port's model parameters: carried over from the JAX package, or
drawn anew.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter tree as
nested dictionaries of NumPy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's: the same names, with the stacked
``layers`` [L, ...] (``src/repro/models/transformer.py:93``,
``mamba_lm.py:40``) split into a list of per-layer dictionaries.
``init_params(cfg, generator, device)`` draws the port's own random
weights (the machine with the card has no JAX); they are drawn on the
CPU, so one seed gives the same weights on every device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX parameter tree (NumPy leaves) as the port's parameters on
    ``device`` (``cuda`` unless asked; raises without a GPU)."""
    dev = resolve_device(device)
    get_model(cfg)                       # families the port cannot run raise

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    out = {k: _tree(leaf, v) for k, v in tree.items() if k != "layers"}
    n = cfg.n_layers
    out["layers"] = [_tree(lambda a, i=i: leaf(np.asarray(a)[i]),
                           tree["layers"]) for i in range(n)]
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights of ``cfg``'s model, drawn on the CPU from
    ``generator`` (seed 0 when absent) and placed on ``device``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = get_model(cfg).init(gen)
    return params if dev.type == "cpu" else _tree(lambda t: t.to(dev), params)
