"""Model factory, abstract inputs and concrete batches (the port of the
JAX package's ``repro.models.registry``).

``input_specs(cfg, shape)`` returns meta tensors — shapes and types, no
storage — for every model input of the step that the shape's ``kind``
runs, as the reference's ``ShapeDtypeStruct`` stand-ins:

  * ``train``   -> ``train_step(state, batch)``
  * ``prefill`` -> ``model.prefill(params, batch)``
  * ``decode``  -> ``model.decode_step(params, cache, tokens)`` (one new
                   token against a KV/state cache of ``seq_len``)

Token ids are int64 here where the reference's are int32 (torch indexes
with int64; ``make_concrete_batch`` draws int64 too); every other type is
the reference's.  A decode cache's ``len`` stays a Python int — the
decode steps read it with ``int()``, which a meta tensor refuses — set to
``seq_len - 1``, so that the step writes the cache's last position and
attends to all of it.  Modality frontends are stubs, as in the reference:
VLM patch embeddings and audio frames are precomputed inputs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import Zamba2LM
from repro_torch.models.layers import dtype_of
from repro_torch.models.mamba_lm import Mamba2LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2_published import Zamba2PublishedLM


def get_model(cfg: ModelConfig):
    """dense/moe/vlm -> TransformerLM, encdec -> EncDecLM, ssm -> Mamba2LM,
    hybrid -> Zamba2LM (Zamba2PublishedLM where the config gives
    ``hybrid_layer_ids``); any other family raises ValueError."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        if cfg.hybrid_layer_ids:
            return Zamba2PublishedLM(cfg)
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


#: the token ids' type (the reference's int32 maps to it)
TOKEN_DTYPE = torch.int64


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, b: int, s: int, *,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """Meta tensors of a batch: tokens [b, s] (and labels); for ``vlm``
    tokens [b, s - n_patches] and ``patch_embeds`` [b, n_patches, d], for
    ``encdec`` ``frames`` [b, s, d] beside them, in the compute type."""
    cdt = dtype_of(cfg.dtype)
    s_text = s - cfg.n_patches if cfg.family == "vlm" else s
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model), cdt)
    if cfg.family == "encdec":
        out["frames"] = _meta((b, s, cfg.d_model), cdt)
    out["tokens"] = _meta((b, s_text), TOKEN_DTYPE)
    if with_labels:
        out["labels"] = _meta((b, s_text), TOKEN_DTYPE)
    return out


def decode_specs(cfg: ModelConfig, b: int, s: int
                 ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(cache, tokens [b]) of ``decode_step``: the cache of the model's own
    ``cache_spec`` as meta tensors, its ``len`` the int ``s - 1``."""
    model = get_model(cfg)
    if cfg.family == "encdec":
        spec = model.cache_spec(b, s, s)
    elif cfg.family == "ssm":
        spec = model.cache_spec(b)
    else:
        spec = model.cache_spec(b, s)
    cache = {name: _meta(shape, dt) for name, (shape, dt) in spec.items()
             if name != "len"}
    if "len" in spec:
        cache["len"] = s - 1
    return cache, _meta((b,), TOKEN_DTYPE)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """The step's inputs for ``shape`` as meta tensors: ``{"batch"}`` for
    train and prefill, ``{"cache", "tokens"}`` for decode.  ``batch``
    replaces the global batch (a device's share of it)."""
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, b, s, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, b, s, with_labels=False)}
    cache, toks = decode_specs(cfg, b, s)
    return {"cache": cache, "tokens": toks}
