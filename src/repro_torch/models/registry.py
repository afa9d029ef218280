"""Model factory and concrete batches (the port of the JAX package's
``repro.models.registry``, for the families the port runs)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.mamba_lm import Mamba2LM
from repro_torch.models.transformer import TransformerLM


def get_model(cfg: ModelConfig):
    """``dense`` -> TransformerLM, ``ssm`` -> Mamba2LM; the other families
    are not ported yet (ROADMAP A8) and raise NotImplementedError."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family in ("encdec", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A8)")
    raise ValueError(f"unknown family {cfg.family}")


def make_concrete_batch(cfg: ModelConfig, b: int, s: int,
                        gen: Optional[torch.Generator] = None, *,
                        with_labels: bool = True,
                        device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """Random token batch [b, s] (and labels) drawn from ``gen`` on the
    CPU, placed on ``device`` (``cuda`` unless asked)."""
    dev = resolve_device(device)
    get_model(cfg)                       # families the port cannot run raise
    out = {}
    for name in ("tokens", "labels") if with_labels else ("tokens",):
        out[name] = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                  dtype=torch.int64).to(dev)
    return out
