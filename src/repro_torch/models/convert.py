"""The port's model parameters: carried over from the JAX package, or
drawn anew.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter tree as
nested dictionaries of NumPy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's: the same names, with every stacked
block list split into a list of per-block dictionaries — ``layers``
[n_layers, ...] (``src/repro/models/transformer.py:93``,
``mamba_lm.py:40``, ``hybrid.py:70``), the hybrid's ``shared``
[n_shared, ...] (``hybrid.py:71``) and the encoder-decoder's
``enc_layers`` [enc_layers, ...] and ``dec_layers`` [n_layers, ...]
(``encdec.py:56,58``).  ``state_from_jax(cfg, state)`` carries a whole
JAX train state across the same way (the moments are parameter-shaped).
``init_params(cfg, generator, device)`` draws the port's own random
weights (the machine with the card has no JAX) on the
generator's device: a generator on the card draws a 7e9-parameter model
in seconds where the CPU takes minutes.  A given generator gives the same
weights wherever they are placed; the default one (seed 0) lives on the
target device, and the card's and the CPU's random streams differ, so
the default weights on ``cpu`` and on ``cuda`` are not the same.
``init_params(cfg, device="meta")`` builds every leaf as a meta tensor —
shape and type, nothing drawn or allocated — so that the dry run holds
the published configs (qwen3-moe-30b-a3b's 120 GB in float32 among them)
on any host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model
from repro_torch.tree import tree_map


def _stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The JAX tree's stacked block lists and their lengths."""
    return {"layers": cfg.n_layers, "shared": cfg.n_shared,
            "enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX parameter tree (NumPy leaves) as the port's parameters on
    ``device`` (``cuda`` unless asked; raises without a GPU)."""
    dev = resolve_device(device)
    get_model(cfg)                       # unknown families raise

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    stacks = _stacks(cfg)
    out = {}
    for k, v in tree.items():
        if k in stacks:
            out[k] = [tree_map(lambda a, i=i: leaf(np.asarray(a)[i]), v)
                      for i in range(stacks[k])]
        else:
            out[k] = tree_map(leaf, v)
    return out


def state_from_jax(cfg: ModelConfig, state: Dict[str, Any],
                   device: DeviceLike = None) -> Dict[str, Any]:
    """A JAX train state (``repro.optim.init_train_state``'s dict with
    NumPy leaves: ``params``, ``m``, ``v``[, ``ef``], ``step``) as the
    port's (``repro_torch.optim``) on ``device`` (``cuda`` unless asked):
    each parameter-shaped tree through ``params_from_jax``, ``step`` an
    int32 scalar."""
    dev = resolve_device(device)
    out = {k: params_from_jax(cfg, state[k], dev)
           for k in ("params", "m", "v", "ef") if k in state}
    out["step"] = torch.tensor(int(state["step"]), dtype=torch.int32,
                               device=dev)
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights of ``cfg``'s model, drawn from ``generator`` on its
    own device (seed 0 on ``device`` when absent, so the default weights
    differ between devices) and placed on ``device`` (``cuda`` unless
    asked)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        with _OnMeta():
            return get_model(cfg).init(torch.Generator())
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(0)
    params = get_model(cfg).init(gen)
    if gen.device.type == dev.type:
        return params
    return tree_map(lambda t: t.to(dev), params)


#: the factories the models' ``init`` calls (``device=`` the generator's)
_FACTORIES = {torch.empty, torch.zeros, torch.ones, torch.randn, torch.rand}


class _OnMeta(TorchFunctionMode):
    """While active, the tensor factories of ``_FACTORIES`` allocate on the
    meta device whatever device they are given; operations on meta
    tensors (``trunc_normal_``, ``log``, ``.to(dtype)``) draw nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _FACTORIES:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)
