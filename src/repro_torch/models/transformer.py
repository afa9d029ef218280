"""Decoder-only transformer LM in PyTorch — the port of the JAX package's
``repro.models.transformer`` for the ``dense`` family (smollm-135m and
the other GQA llama-style configs).

Parameters are ``{"embed", "layers": [per-layer dict, ...],
"final_norm"[, "unembed"]}`` (the JAX package stacks ``layers`` along a
leading ``L`` dimension; ``models.convert.params_from_jax`` unstacks).
Caches keep the JAX layout: ``k``/``v`` [L, B, Smax, Hkv, D] and ``len``
(an int here, a scalar array there).

The causal prefill sends its attention through the flash-attention kernel
(``kernels.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU), one launch per layer.  ``forward`` keeps the JAX
package's plain attention (``layers.attn_forward``), and decode attends
with plain torch (``layers.attention_decode``: one query against the
cache; the kernel's causal mask assumes query and key positions both
start at 0).  The ``moe`` and ``vlm`` families wait (ROADMAP A8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

F32 = torch.float32
Params = Dict[str, Any]


class TransformerLM:
    """family ``dense``; ``moe`` and ``vlm`` raise (not ported yet)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's TransformerLM runs the "
                f"dense family only; moe and vlm wait (ROADMAP A8)")
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)

    # ---------------- params ----------------
    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn on the CPU from ``gen``."""
        cfg = self.cfg
        params = {
            "embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  self.pdt),
            "layers": [{
                "attn": L.init_attn(gen, cfg, self.pdt),
                "ln1": torch.zeros((cfg.d_model,), dtype=self.pdt),
                "ln2": torch.zeros((cfg.d_model,), dtype=self.pdt),
                "mlp": L.init_mlp(gen, cfg, self.pdt),
            } for _ in range(cfg.n_layers)],
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.pdt),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_padded), self.pdt)
        return params

    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.cdt)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return (x @ self._unembed(params).to(self.cdt)).to(F32)

    # ---------------- forward ----------------
    def forward(self, params, batch) -> torch.Tensor:
        """Full logits [B, S, V] (small inputs only; tests)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in params["layers"]:
            x = x + L.attn_forward(lp["attn"],
                                   L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                   cfg, positions, causal=True)
            x = x + L.mlp_forward(lp["mlp"],
                                  L.rms_norm(x, lp["ln2"], cfg.norm_eps))
        return self._logits(params, x)

    # ---------------- serve ----------------
    def prefill(self, params, batch, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Process the whole prompt; return last-token logits [B, V] and
        the KV cache (padded to ``max_len`` positions)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        ks, vs = [], []
        for lp in params["layers"]:
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_proj(lp["attn"], hn, cfg, positions)
            o = flash_attention(q, k, v, causal=True)
            x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"].to(x.dtype)
            x = x + L.mlp_forward(lp["mlp"],
                                  L.rms_norm(x, lp["ln2"], cfg.norm_eps))
            ks.append(k)
            vs.append(v)
        logits = self._logits(params, x[:, -1:])[:, 0]
        total = max(s, max_len or 0)
        shape = (cfg.n_layers, b, total, cfg.n_kv_heads, cfg.head_dim)
        k_all = x.new_zeros(shape)
        v_all = x.new_zeros(shape)
        k_all[:, :, :s] = torch.stack(ks)
        v_all[:, :, :s] = torch.stack(vs)
        if cfg.kv_quant:
            kq, k_s = _kv_quantize(k_all)
            vq, v_s = _kv_quantize(v_all)
            return logits, {"k": kq, "v": vq, "k_s": k_s, "v_s": v_s,
                            "len": s}
        return logits, {"k": k_all, "v": v_all, "len": s}

    def cache_spec(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """{name: (shape, dtype)} of the decode cache (``len`` an int)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        if cfg.kv_quant:
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_s": (shape[:-1], F32), "v_s": (shape[:-1], F32),
                    "len": ((), torch.int64)}
        return {"k": (shape, self.cdt), "v": (shape, self.cdt),
                "len": ((), torch.int64)}

    def init_cache(self, batch_size: int, max_len: int,
                   device: DeviceLike = None) -> Params:
        """Zeroed decode cache on ``device`` (``cuda`` unless asked)."""
        dev = resolve_device(device)
        spec = self.cache_spec(batch_size, max_len)
        cache = {name: torch.zeros(shape, dtype=dt, device=dev)
                 for name, (shape, dt) in spec.items() if name != "len"}
        cache["len"] = 0
        return cache

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache with ``len`` + 1).  The new
        token's K/V are written into the cache's buffers in place (the JAX
        package returns new arrays; ``ServeEngine.decode`` works on a copy
        so that a caller's cache is left as it was)."""
        cfg = self.cfg
        x = self._embed(params, tokens)[:, None]                  # [B,1,d]
        clen = int(cache["len"])
        for i, lp in enumerate(params["layers"]):
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            if cfg.kv_quant:
                a = _attn_decode_q(lp["attn"], hn, cfg, cache, i, clen)
            else:
                a = L.attn_decode_forward(lp["attn"], hn, cfg, cache["k"][i],
                                          cache["v"][i], clen)
            x = x + a
            x = x + L.mlp_forward(lp["mlp"],
                                  L.rms_norm(x, lp["ln2"], cfg.norm_eps))
        logits = self._logits(params, x)[:, 0]
        return logits, {**cache, "len": clen + 1}


def _attn_decode_q(p, x, cfg: ModelConfig, cache, i: int, clen: int):
    """int8-KV decode attention of layer ``i``: the new token's K/V are
    quantised before the write, the layer's cache dequantised to read."""
    b = x.shape[0]
    pos = torch.full((b, 1), clen, dtype=torch.int64, device=x.device)
    q, k, v = L.qkv_proj(p, x, cfg, pos)
    for name, new in (("k", k), ("v", v)):
        qv, sc = _kv_quantize(new)
        cache[name][i][:, clen] = qv[:, 0]
        cache[name + "_s"][i][:, clen] = sc[:, 0]
    k_full = _kv_dequantize(cache["k"][i], cache["k_s"][i], x.dtype)
    v_full = _kv_dequantize(cache["v"][i], cache["v_s"][i], x.dtype)
    o = L.attention_decode(q, k_full, v_full, clen + 1)
    return o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)


def _kv_quantize(x):
    """x: [..., Dh] -> (int8 [..., Dh], float32 absmax scale [...])."""
    xf = x.to(F32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q, scale, dtype):
    return (q.to(F32) * scale[..., None]).to(dtype)
