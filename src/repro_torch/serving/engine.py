"""Model serving engine: prefill + greedy/temperature decode around a
model's ``prefill`` and ``decode_step`` (the port of the JAX package's
``repro.serving.engine``).

PyTorch runs eagerly, so nothing is compiled per shape.  The engine runs
on ``cuda`` unless asked for the CPU (and raises without a GPU); its
weights are ``params`` when given, else drawn from ``generator`` (seed 0
on the engine's device) by ``models.convert.init_params``.  The default
draw depends on the device: seed 0 on the card and seed 0 on the CPU give
different weights, so an engine on ``cpu`` and one on ``cuda`` built
without ``params`` serve different models.  Pass one CPU generator (or
the same ``params``) to both for the same weights.

As the JAX engine does, it feeds the stub frontends zeros in the compute
type: a ``vlm`` prompt gets ``patch_embeds`` [B, n_patches, d] before its
tokens, an ``encdec`` prompt ``frames`` [B, S, d] as long as its tokens.
Unlike it, a ``vlm`` cache holds ``n_patches + max_len`` positions: the
JAX launcher's ``max_len`` (``src/repro/launch/serve.py:115``) does not
count the patches, so its cache is never padded and every decode step's
write lands clamped on the last prompt slot (ROADMAP C-ref-8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import get_model, init_params
from repro_torch.models.layers import dtype_of

Cache = Dict[str, Any]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = get_model(cfg)
        self.params = params if params is not None else \
            init_params(cfg, generator, self.device)

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
        """Last-token logits [B, V] and the cache of prompt ``tokens``
        [B, S]; a KV cache holds ``max_len`` positions, ``n_patches`` more
        for ``vlm`` (the ssm family's state does not grow, so it takes no
        ``max_len``)."""
        with tracing.span("prefill"):
            cfg = self.cfg
            batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                               dtype=torch.int64,
                                               device=self.device)}
            b, s = batch["tokens"].shape
            cdt = dtype_of(cfg.dtype)
            if cfg.family == "ssm":
                return self.model.prefill(self.params, batch)
            if cfg.family == "vlm":
                batch["patch_embeds"] = torch.zeros(
                    (b, cfg.n_patches, cfg.d_model), dtype=cdt,
                    device=self.device)
                max_len = cfg.n_patches + max_len
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros((b, s, cfg.d_model), dtype=cdt,
                                              device=self.device)
            return self.model.prefill(self.params, batch, max_len=max_len)

    @torch.no_grad()
    def decode(self, cache: Cache, first_tokens, n_steps: int,
               temperature: float = 0.0,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[np.ndarray, Cache]:
        """Decode ``n_steps`` tokens from ``first_tokens`` [B].  Greedy
        (argmax over the padded vocab, then clipped to ``vocab - 1``) at
        temperature 0, else sampled.  Works on a copy of ``cache``, which
        is left as it was (a router may hand the same prefix cache to
        many requests)."""
        with tracing.span("decode"):
            cache = {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in cache.items()}
            toks = torch.as_tensor(np.asarray(first_tokens),
                                   dtype=torch.int64, device=self.device)
            out = []
            for _ in range(n_steps):
                with tracing.span("decode.step"):
                    logits, cache = self.model.decode_step(self.params,
                                                           cache, toks)
                    if temperature > 0:
                        probs = torch.softmax(logits / temperature, dim=-1)
                        toks = torch.multinomial(probs, 1,
                                                 generator=generator)[:, 0]
                    else:
                        toks = torch.argmax(logits, dim=-1)
                    toks = torch.clamp(toks, 0, self.cfg.vocab - 1)
                    out.append(toks.cpu().numpy().astype(np.int32))
            return np.stack(out, axis=1), cache
