"""Model serving engine: prefill + greedy/temperature decode around a
model's ``prefill`` and ``decode_step`` (the port of the JAX package's
``repro.serving.engine``).

PyTorch runs eagerly, so nothing is compiled per shape.  The engine runs
on ``cuda`` unless asked for the CPU (and raises without a GPU); its
weights are ``params`` when given, else drawn from ``generator`` (seed 0)
by ``models.convert.init_params``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import get_model, init_params

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
        [B, S]; a transformer's KV cache holds ``max_len`` positions (the
        ssm family's state does not grow, so it takes no ``max_len``)."""
        batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                           dtype=torch.int64,
                                           device=self.device)}
        if self.cfg.family == "ssm":
            return self.model.prefill(self.params, batch)
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
        cache = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in cache.items()}
        toks = torch.as_tensor(np.asarray(first_tokens), dtype=torch.int64,
                               device=self.device)
        out = []
        for _ in range(n_steps):
            logits, cache = self.model.decode_step(self.params, cache, toks)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                toks = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                toks = torch.argmax(logits, dim=-1)
            toks = torch.clamp(toks, 0, self.cfg.vocab - 1)
            out.append(toks.cpu().numpy().astype(np.int32))
        return np.stack(out, axis=1), cache
