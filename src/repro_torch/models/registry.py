"""Model factory and concrete batches (the port of the JAX package's
``repro.models.registry``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import Zamba2LM
from repro_torch.models.layers import dtype_of
from repro_torch.models.mamba_lm import Mamba2LM
from repro_torch.models.transformer import TransformerLM


def get_model(cfg: ModelConfig):
    """dense/moe/vlm -> TransformerLM, encdec -> EncDecLM, ssm -> Mamba2LM,
    hybrid -> Zamba2LM; any other family raises ValueError."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    raise ValueError(f"unknown family {cfg.family}")


def make_concrete_batch(cfg: ModelConfig, b: int, s: int,
                        gen: Optional[torch.Generator] = None, *,
                        with_labels: bool = True,
                        device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """A random batch of the JAX package's ``batch_specs`` shapes, drawn
    from ``gen`` on the CPU and placed on ``device`` (``cuda`` unless
    asked): tokens [b, s] (and labels); for ``vlm`` tokens [b, s -
    n_patches] after ``patch_embeds`` [b, n_patches, d], for ``encdec``
    ``frames`` [b, s, d] beside them, both standard normal in the compute
    type."""
    dev = resolve_device(device)
    get_model(cfg)                       # unknown families raise
    s_text = s - cfg.n_patches if cfg.family == "vlm" else s
    names = ("tokens", "labels") if with_labels else ("tokens",)
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = (b, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        out["frames"] = (b, s, cfg.d_model)
    for name, shape in list(out.items()):
        out[name] = torch.randn(shape, generator=gen).to(
            dtype_of(cfg.dtype)).to(dev)
    for name in names:
        out[name] = torch.randint(0, cfg.vocab, (b, s_text), generator=gen,
                                  dtype=torch.int64).to(dev)
    return out
