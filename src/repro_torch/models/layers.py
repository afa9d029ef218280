"""Shared transformer building blocks in PyTorch (the port of the JAX
package's ``repro.models.layers`` for the dense serving path).

Parameters are plain dictionaries of tensors, one per layer (the JAX
package stacks them along a leading ``L`` dimension for ``lax.scan``;
``models.convert.params_from_jax`` unstacks).  Arithmetic follows the
JAX code: norms and rotary embeddings in float32, attention scores in
float32, probabilities rounded to the value type before the PV product.

Attention here is plain torch: ``attention_naive`` / ``attention_chunked``
(the forward pass) and ``attention_decode`` (one query against the KV
cache).  The causal prefill goes through the flash-attention kernel
instead (``kernels.flash_attention``, called by ``models.transformer``).
MoE (``init_moe``, ``moe_forward``) is not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -2.0e38
F32 = torch.float32

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers (an explicit generator: the port draws its own weights)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (truncated at +-2, then scaled)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=F32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=F32) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    """RMS norm with the ``(1 + w)`` weight convention, in float32."""
    dt = x.dtype
    x = x.to(F32)
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(F32))).to(dt)


def gated_rms_norm(x, gate, w, eps: float = 1e-5):
    """Mamba2-style norm(x * silu(gate))."""
    dt = x.dtype
    x = x.to(F32) * F.silu(gate.to(F32))
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(F32))).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] integers.  Split halves (not
    interleaved), computed in float32."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), device=x.device)  # [D/2]
    ang = positions[..., None].to(F32) * freqs                     # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].to(F32), x[..., d // 2:].to(F32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig, pdt) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, hq * dh), pdt),
        "wk": dense_init(gen, (d, hkv * dh), pdt),
        "wv": dense_init(gen, (d, hkv * dh), pdt),
        "wo": dense_init(gen, (hq * dh, d), pdt,
                         scale=1.0 / math.sqrt(hq * dh)),
    }


def _gqa_scores(q, k):
    """q: [B,Sq,Hkv,G,D]  k: [B,Sk,Hkv,D] -> [B,Hkv,G,Sq,Sk] (float32; the
    products of bf16 inputs are exact in float32, as JAX's
    ``preferred_element_type`` gives)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.to(F32), k.to(F32))


def _gqa_out(p, v):
    """p: [B,Hkv,G,Sq,Sk]  v: [B,Sk,Hkv,D] -> [B,Sq,Hkv,G,D] in v's type."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def attention_naive(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference attention.  q: [B,Sq,Hq,D], k/v: [B,Sk,Hkv,D]."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh) * (dh ** -0.5)
    s = _gqa_scores(qg, k)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).reshape(b, sq, hq, dh)


def attention_chunked(q, k, v, *, causal: bool, chunk: int,
                      q_offset: int = 0):
    """Memory-bounded attention: a loop over query chunks, never more than
    [B,Hkv,G,chunk,Sk] scores at once (the JAX package's ``lax.scan``)."""
    b, sq, hq, dh = q.shape
    if sq % chunk != 0 or sq <= chunk:
        return attention_naive(q, k, v, causal=causal, q_offset=q_offset)
    outs = [attention_naive(q[:, i:i + chunk], k, v, causal=causal,
                            q_offset=q_offset + i)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, cache_len: int):
    """Single-step decode.  q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D]; the
    first ``cache_len`` cache positions are attended."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dh) * (dh ** -0.5)
    s = _gqa_scores(qg, k_cache)                       # [B,Hkv,G,1,Smax]
    valid = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v_cache).reshape(b, 1, hq, dh)


def qkv_proj(p: Params, x, cfg: ModelConfig, positions):
    """q [B,S,Hq,D] and k, v [B,S,Hkv,D] of ``x`` [B,S,d], rotary applied
    to q and k."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = x.dtype
    q = (x @ p["wq"].to(cdt)).reshape(b, s, hq, dh)
    k = (x @ p["wk"].to(cdt)).reshape(b, s, hkv, dh)
    v = (x @ p["wv"].to(cdt)).reshape(b, s, hkv, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_forward(p: Params, x, cfg: ModelConfig, positions, *,
                 causal: bool = True):
    """Full-sequence self-attention block body (plain torch).  x: [B,S,d]."""
    b, s, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg, positions)
    if cfg.attn_mode == "naive":
        o = attention_naive(q, k, v, causal=causal)
    else:
        o = attention_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return o.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def attn_decode_forward(p: Params, x, cfg: ModelConfig, cache_k, cache_v,
                        cache_len: int):
    """One-token attention with a KV cache update.  x: [B,1,d]; the caches
    [B,Smax,Hkv,D] get the new token's k, v written at ``cache_len`` in
    place.  Returns out [B,1,d]."""
    b = x.shape[0]
    pos = torch.full((b, 1), cache_len, dtype=torch.int64, device=x.device)
    q, k, v = qkv_proj(p, x, cfg, pos)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    o = attention_decode(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                         cache_len + 1)
    return o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, pdt,
             d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": dense_init(gen, (d, f), pdt),
        "wi": dense_init(gen, (d, f), pdt),
        "wo": dense_init(gen, (f, d), pdt),
    }


def mlp_forward(p: Params, x):
    cdt = x.dtype
    h = F.silu(x @ p["wg"].to(cdt)) * (x @ p["wi"].to(cdt))
    return h @ p["wo"].to(cdt)
