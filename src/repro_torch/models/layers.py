"""Shared transformer building blocks in PyTorch (the port of the JAX
package's ``repro.models.layers`` for the dense serving path).

Parameters are plain dictionaries of tensors, one per layer (the JAX
package stacks them along a leading ``L`` dimension for ``lax.scan``;
``models.convert.params_from_jax`` unstacks).  Arithmetic follows the
JAX code: norms and rotary embeddings in float32, attention scores in
float32, probabilities rounded to the value type before the PV product.

Attention here is plain torch: ``attention_naive`` / ``attention_chunked``
(the forward pass) and ``attention_decode`` (one query against the KV
cache).  The prefills go through the flash-attention kernel instead
(``flash_attn``, which every model's prefill calls).  A decode cache laid
out by ``launch.specs`` (``decode_inputs``) holds a slice of the KV
sequence a rank (``SeqShard``): ``attention_decode`` then reduces the
softmax's statistics and the partial outputs over the ranks that share
the sequence, as XLA partitions the reference's masked softmax, and only
the rank whose slice holds the new position writes it.

MoE (``init_moe``, ``moe_forward``): a float32 router over the padded
expert count (padded experts masked out), top-k by a stable descending
sort (``jax.lax.top_k`` breaks ties toward the lower index), and either
every expert on every token (``dense``) or the reference's sort-based
capacity dispatch (``dispatch``: groups of tokens, a stable argsort over
the expert ids, slots past the capacity dropped to a zero row, combined
through the inverse permutation).  The expert products are batched
matrix products outside any kernel, as in the JAX package.

Expert parallelism (``_moe_shardmap``, the reference's ``shard_map``
path): under installed mesh rules (``distributed.sharding``) and a full
sequence, ``moe_forward`` cuts each rank's block of tokens out of the
replicated activations (batch over the data axes, sequence over
``model``; ``sharding.scatter``, whose backward all-gathers), buckets them locally at the per-shard capacity
``max(4, ceil(t_loc k / E * capacity_factor))``, sends each expert's
buffer to the rank that holds it (``all_to_all_single`` over the model
axis' group, an autograd function whose backward is the same exchange),
runs the local experts on their local weights (``to_local`` of the
expert-sharded DTensors, their gradient summed over the data axes by
``sharding.sum_grad``), exchanges back, combines, and all-gathers the
blocks into replicated activations again (``sharding.gather``; backward:
the local slice).  It returns None — the
pure path — when the shapes do not tile the mesh.  The other parameters
reach these functions as the rank's shards (``distributed.tp``; gathered
by ``sharding.unshard`` in ``forward``); an expert weight reaching the
pure path in another layout is gathered in ``_experts``.

Training on the shards (``attn_forward``, ``mlp_forward``,
``moe_forward``) uses the same products as serving; every collective
there carries its backward (``distributed.tp``), and ``seq_norm`` sums
a replicated norm weight's gradient over the model axis where the rank
normed its block of a sequence-parallel residual.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -2.0e38
F32 = torch.float32

Params = Dict[str, torch.Tensor]
#: a decode cache's length: an int, or a 0-d int64 tensor on the device
Length = Union[int, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers (an explicit generator: the port draws its own weights, on
# the generator's device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (truncated at +-2, then scaled)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
            * 0.02).to(dtype)


def zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Zeros on the generator's device (norm weights, biases)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


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


def gated_rms_norm(x, gate, w, eps: float = 1e-5, ax=None):
    """Mamba2-style norm(x * silu(gate)); with ``ax`` (a ``distributed.tp``
    axis) ``x``, ``gate`` and ``w`` are the rank's block of the normed dim
    and the sum of squares is all-reduced over it in float32."""
    dt = x.dtype
    x = x.to(F32) * F.silu(gate.to(F32))
    if ax is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:   # each rank's block reads the whole sum: its gradient summed
        var = tp.sum_grad(tp.sum_f32(x.square().sum(dim=-1, keepdim=True),
                                     ax), ax) / (x.shape[-1] * ax.size)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(F32))).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=32)
def rope_freqs_on(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as a float32 tensor on ``device``, made once per
    (head dim, theta, device): a CUDA graph's step cannot copy host memory
    to the card, so the first call has to come before any capture (a
    decode graph's warm-up makes it).  It is made outside any dispatch
    mode, so that a cost trace counts the same operations whether or not
    an earlier call made it.  Callers only read it."""
    with _disable_current_modes(), torch.inference_mode(False), \
            torch.no_grad():
        return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] integers.  Split halves (not
    interleaved), computed in float32."""
    d = x.shape[-1]
    freqs = rope_freqs_on(d, theta, x.device)                      # [D/2]
    ang = positions[..., None].to(F32) * freqs                     # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].to(F32), x[..., d // 2:].to(F32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig, pdt,
              d_in: Optional[int] = None) -> Params:
    """q, k, v projections from ``d_in`` (``d_model`` unless given) and
    the output projection back to ``d_model``."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    di = d_in or d
    return {
        "wq": dense_init(gen, (di, hq * dh), pdt),
        "wk": dense_init(gen, (di, hkv * dh), pdt),
        "wv": dense_init(gen, (di, hkv * dh), pdt),
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


def attention_naive(q, k, v, *, causal: bool, q_offset: int = 0,
                    scale: Optional[float] = None):
    """Reference attention.  q: [B,Sq,Hq,D], k/v: [B,Sk,Hkv,D]; the scores
    scaled by ``scale`` (D^-1/2 when None)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh) * (dh ** -0.5 if scale is None
                                         else scale)
    s = _gqa_scores(qg, k)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).reshape(b, sq, hq, dh)


def attention_chunked(q, k, v, *, causal: bool, chunk: int,
                      q_offset: int = 0, scale: Optional[float] = None):
    """Memory-bounded attention: a loop over query chunks, never more than
    [B,Hkv,G,chunk,Sk] scores at once (the JAX package's ``lax.scan``)."""
    b, sq, hq, dh = q.shape
    if sq % chunk != 0 or sq <= chunk:
        return attention_naive(q, k, v, causal=causal, q_offset=q_offset,
                               scale=scale)
    outs = [attention_naive(q[:, i:i + chunk], k, v, causal=causal,
                            q_offset=q_offset + i, scale=scale)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


@dataclass(frozen=True)
class SeqShard:
    """A decode cache's sequence cut into ``parts`` equal contiguous
    slices over mesh dims (``launch.specs.cache_shardings``): this rank
    holds slice ``index``; the attention reduces over ``groups``, the
    process groups of those dims."""
    index: int
    parts: int
    groups: tuple

    def start(self, local_len: int) -> int:
        return self.index * local_len


def local_position(pos: int, local_len: int, seq: Optional[SeqShard]):
    """The index in this rank's cache slice of sequence position ``pos``;
    None when another rank's slice holds it."""
    if seq is None:
        return pos
    i = pos - seq.start(local_len)
    return i if 0 <= i < local_len else None


def attention_decode(q, k_cache, v_cache, cache_len: Length,
                     seq: Optional[SeqShard] = None,
                     scale: Optional[float] = None):
    """Single-step decode.  q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D]; the
    first ``cache_len`` cache positions are attended (an int, or a 0-d
    integer tensor on q's device: the mask is then a device comparison,
    the same values).  With ``seq`` the
    caches are this rank's slice of the sequence, and the softmax runs
    as XLA partitions it: local scores masked by their global positions,
    a MAX all-reduce of the row maxima (exact), the local ``exp`` and a
    SUM all-reduce of its float32 sums, ``p`` cast to ``v``'s type and the
    local P.V, whose float32 partial outputs are summed over ``seq.groups``
    (only the order of the sums differs from one device's)."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, dh) * (dh ** -0.5 if scale is None
                                        else scale)
    s = _gqa_scores(qg, k_cache)                       # [B,Hkv,G,1,Smax]
    start = 0 if seq is None else seq.start(k_cache.shape[1])
    valid = torch.arange(start, start + k_cache.shape[1],
                         device=q.device) < cache_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    if seq is None:
        p = torch.softmax(s, dim=-1)
        return _gqa_out(p, v_cache).reshape(b, 1, hq, dh)
    # a slice wholly past cache_len has maxima NEG_INF, which is finite:
    # its exp against the global maximum is 0, never exp(-inf + inf)
    mx = s.amax(dim=-1, keepdim=True)
    for grp in seq.groups:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=grp)
    e = torch.exp(s - mx)
    z = e.sum(dim=-1, keepdim=True)
    for grp in seq.groups:
        dist.all_reduce(z, group=grp)
    o = torch.einsum("bhgqk,bkhd->bqhgd", (e / z).to(v_cache.dtype).to(F32),
                     v_cache.to(F32))
    for grp in seq.groups:
        dist.all_reduce(o, group=grp)
    return o.to(v_cache.dtype).reshape(b, 1, hq, dh)


def qkv_proj(p: Params, x, cfg: ModelConfig, positions, sp=None):
    """q [B,S,Hq,D] and k, v [B,S,Hkv,D] of ``x`` [B,S,d], rotary applied
    to q and k; with ``sp`` ``x`` is the whole sequence from
    ``tp.gather_seq`` (``tp.cols``)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    (q, aq), (k, ak), (v, av) = tp.cols(x, (p["wq"], p["wk"], p["wv"]), sp)
    q = tp.gather(q, -1, aq).reshape(b, s, hq, dh)
    k = tp.gather(k, -1, ak).reshape(b, s, hkv, dh)
    v = tp.gather(v, -1, av).reshape(b, s, hkv, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def cross_kv(p: Params, enc, cfg: ModelConfig, sp=None):
    """k, v [B,Se,Hkv,D] of the encoder states ``enc`` [B,Se,d] (with
    ``sp`` gathered by ``tp.gather_seq``)."""
    b, se, _ = enc.shape
    shape = (b, se, cfg.n_kv_heads, cfg.head_dim)
    (k, ak), (v, av) = tp.cols(enc, (p["wk"], p["wv"]), sp)
    return (tp.gather(k, -1, ak).reshape(shape),
            tp.gather(v, -1, av).reshape(shape))


def _rank_heads(p: Params, cfg: ModelConfig):
    """(axis, whether the KV heads are the rank's own columns too) where
    this rank computes its block of the q heads on its own ``wq`` columns
    — the axis divides Hq, the rules cut ``wq`` over its columns and
    ``wo`` over its rows — else (None, False).  The KV heads are the
    rank's own columns where the axis divides Hkv and the rules cut
    ``wk``/``wv`` so: exactly the heads its q heads read."""
    ax = tp.axis_of(p["wq"], p["wo"])
    if ax is None or cfg.n_heads % ax.size or \
            [tp.part(p[n])[1] for n in ("wq", "wo")] != [1, 0]:
        return None, False
    own_kv = cfg.n_kv_heads % ax.size == 0 and \
        [tp.part(p[n])[1] for n in ("wk", "wv")] == [1, 1]
    return ax, own_kv


def kv_heads(k, v, ax, hq: int):
    """k, v [B,S,Hkv,D] (whole) cut to the KV heads that the rank's block
    of ``hq`` q heads reads, in the layout the grouping ``h // (Hq/Hkv)``
    of the block expects: a whole number of groups, one shared KV head,
    or else each q head's KV head repeated."""
    n, g = hq // ax.size, hq // k.shape[2]
    h0 = ax.rank * n
    if n % g == 0 or g % n == 0:
        kv = slice(h0 // g, h0 // g + max(1, n // g))
        return k[:, :, kv], v[:, :, kv]
    idx = torch.arange(h0, h0 + n, device=k.device) // g
    return k[:, :, idx], v[:, :, idx]


def attn_forward(p: Params, x, cfg: ModelConfig, positions, *,
                 causal: bool = True, kv_override=None, sp=None,
                 kv_sp=None):
    """Full-sequence attention block body (plain torch).  x: [B,S,d]; with
    ``kv_override`` (encoder states [B,Se,d]) it is cross attention, k and
    v from those states and no rotary on q or k.

    On the model axis (``distributed.tp``) each rank computes the q heads
    of its own columns where the layout allows (:func:`_rank_heads`;
    their KV heads its own columns too, or cut from the gathered whole,
    whose gradient the ranks' parts then sum), else every head from the
    gathered columns; ``wo`` is row-parallel.  With ``sp`` ``x`` is the
    whole sequence from ``tp.gather_seq`` and the output the rank's block
    of it; ``kv_sp`` likewise for ``kv_override``."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ax, own_kv = _rank_heads(p, cfg)
    cross = kv_override is not None
    src, src_sp = (kv_override.to(x.dtype), kv_sp) if cross else (x, sp)
    if ax is None:
        if cross:
            q = tp.col_full(x, p["wq"], sp).reshape(b, s, hq, dh)
            k, v = cross_kv(p, src, cfg, src_sp)
        else:
            q, k, v = qkv_proj(p, x, cfg, positions, sp)
    else:
        q = tp.col(x, p["wq"], sp)[0].reshape(b, s, hq // ax.size, dh)
        if own_kv:
            (k, _), (v, _) = tp.cols(src, (p["wk"], p["wv"]), src_sp)
            shape = (b, src.shape[1], hkv // ax.size, dh)
            k, v = k.reshape(shape), v.reshape(shape)
        else:
            k, v = cross_kv(p, src, cfg, src_sp)
        if not cross:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if not own_kv:
            k, v = kv_heads(tp.sum_grad(k, ax), tp.sum_grad(v, ax), ax, hq)
    if cfg.attn_mode == "naive":
        o = attention_naive(q, k, v, causal=causal, scale=cfg.softmax_scale)
    else:
        o = attention_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                              scale=cfg.softmax_scale)
    return tp.row(o.reshape(b, s, -1), p["wo"], ax, sp)


def flash_attn(p: Params, hn, cfg: ModelConfig, positions, *,
               causal: bool, kv=None, sp=None):
    """A prefill attention block through the flash kernel: (out [B,S,d],
    k, v).  Self attention of ``hn`` [B,S,d] (rotary on q and k), or with
    ``kv`` (k, v [B,Se,Hkv,D] of the encoder states) cross attention, q
    without rotary.  On the model axis (``distributed.tp``) the rank
    computes the q heads of its own ``wq`` columns where the layout allows
    (:func:`_rank_heads`), else every head from the gathered columns; k
    and v are whole (the cache holds them), the kernel reads the KV heads
    of the rank's q heads (:func:`kv_heads`) and ``wo`` is row-parallel;
    with ``sp`` (``hn`` the whole sequence of a sequence-parallel
    residual) ``out`` is the rank's block of the sequence."""
    b, s, _ = hn.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ax, _ = _rank_heads(p, cfg)
    if kv is None:
        (q, aq), (k, ak), (v, av) = tp.cols(hn, (p["wq"], p["wk"], p["wv"]))
        k = apply_rope(tp.gather(k, -1, ak).reshape(b, s, hkv, dh),
                       positions, cfg.rope_theta)
        v = tp.gather(v, -1, av).reshape(b, s, hkv, dh)
    else:
        q, aq = tp.col(hn, p["wq"])
        k, v = (t.to(hn.dtype) for t in kv)
    if ax is None:
        q = tp.gather(q, -1, aq)
    q = q.reshape(b, s, -1, dh)
    if kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
    kl, vl = (k, v) if ax is None else kv_heads(k, v, ax, hq)
    o = flash_attention(q.contiguous(), kl.contiguous(), vl.contiguous(),
                        causal=causal, scale=cfg.softmax_scale)
    return tp.row(o.reshape(b, s, -1), p["wo"], ax, sp), k, v


def stack_kv(ks, vs, max_len: Optional[int]):
    """The per-layer prefill K/V [B,S,Hkv,D] stacked [L,B,Smax,Hkv,D] and
    zero-padded to ``max_len`` positions (at least S)."""
    k, v = torch.stack(ks), torch.stack(vs)
    pad = max(0, (max_len or 0) - k.shape[2])
    return (F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)))


def zero_cache(spec, device) -> Dict:
    """The decode cache of ``spec`` ({name: (shape, dtype)}) zeroed on
    ``device``; its ``len`` 0."""
    cache = {name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in spec.items() if name != "len"}
    cache["len"] = 0
    return cache


def attn_decode_forward(p: Params, x, cfg: ModelConfig, cache_k, cache_v,
                        cache_len: Length, seq: Optional[SeqShard] = None):
    """One-token attention with a KV cache update.  x: [B,1,d]; the caches
    [B,Smax,Hkv,D] get the new token's k, v written at ``cache_len`` in
    place (with ``seq``: the caches are this rank's sequence slice, and
    only the rank whose slice holds ``cache_len`` writes).  Returns out
    [B,1,d].

    ``cache_len`` is an int, or a 0-d int64 tensor on ``x``'s device (a
    CUDA graph's step, whose length changes between replays): the rotary
    position, the write and the mask are then device operations on it,
    with the same values, and the caller keeps it below ``Smax`` (no
    ``seq``: one device)."""
    b = x.shape[0]
    if isinstance(cache_len, torch.Tensor):
        if seq is not None:
            raise ValueError("a tensor cache length decodes on one device: "
                             "a sequence-sharded cache takes an int")
        q, k, v = qkv_proj(p, x, cfg, cache_len.reshape(1, 1).expand(b, 1))
        at = cache_len.reshape(1)
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    else:
        pos = torch.full((b, 1), cache_len, dtype=torch.int64,
                         device=x.device)
        q, k, v = qkv_proj(p, x, cfg, pos)
        at = local_position(cache_len, cache_k.shape[1], seq)
        if at is not None:
            cache_k[:, at] = k[:, 0].to(cache_k.dtype)
            cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    o = attention_decode(q, cache_k.to(x.dtype), cache_v.to(x.dtype),
                         cache_len + 1, seq, cfg.softmax_scale)
    return tp.row(o.reshape(b, 1, -1), p["wo"])


def decode_inputs(cache, tokens):
    """A decode step's inputs as this rank computes on them: (the cache's
    local tensors, the local tokens, the KV sequence's :class:`SeqShard`
    or None, and a function laying the logits out as the tokens).  Inputs
    laid out by ``launch.specs`` (DTensors: the batch over the data axes,
    the KV sequence as ``cache_shardings`` cuts it) give this rank's part;
    plain inputs pass as they are."""
    from torch.distributed.tensor import DTensor, Shard

    seq = None
    kv = next((cache[n] for n in ("k", "ck") if n in cache), None)
    if isinstance(kv, DTensor):
        mesh = kv.device_mesh
        dims = [i for i, pl in enumerate(kv.placements)
                if isinstance(pl, Shard) and pl.dim == 2]
        parts = math.prod(mesh.size(i) for i in dims)
        if parts > 1:
            seq = SeqShard(shd.data_index(mesh, dims), parts,
                           tuple(mesh.get_group(i) for i in dims
                                 if mesh.size(i) > 1))
    local = {k: shd.local(v) for k, v in cache.items()}

    def wrap(logits):
        if not isinstance(tokens, DTensor):
            return logits
        shape = (tokens.shape[0], logits.shape[1])
        return DTensor.from_local(logits, tokens.device_mesh,
                                  tokens.placements, run_check=False,
                                  shape=shape, stride=(shape[1], 1))
    return local, shd.local(tokens), seq, wrap


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


def mlp_forward(p: Params, x, sp=None):
    """SwiGLU MLP of ``x`` [B,S,d]: ``wg``/``wi`` column-parallel on the
    model axis, the gate and the activation on the rank's own ``d_ff``
    columns, ``wo`` row-parallel (``distributed.tp``); with ``sp`` ``x``
    is the whole sequence from ``tp.gather_seq`` and the output the
    rank's block of it."""
    (g, ax), (u, ax_u) = tp.cols(x, (p["wg"], p["wi"]), sp)
    if ax_u != ax:                       # one cut, the other whole
        g, u, ax = tp.gather(g, -1, ax), tp.gather(u, -1, ax_u), None
    return tp.row(F.silu(g) * u, p["wo"], ax, sp)


def mlp_residual(p: Params, ln, x, eps: float, sp=None):
    """``x`` plus the MLP of its RMS norm (weight ``ln``); with ``sp``
    ``x`` is the rank's block of a sequence-parallel residual (``ln``'s
    gradient then summed over the model axis: ``seq_norm``)."""
    return x + mlp_forward(p, tp.gather_seq(seq_norm(x, ln, eps, sp), sp),
                           sp)


def seq_norm(x, w, eps: float, sp=None):
    """``rms_norm(x, w)``; with ``sp`` ``x`` is the rank's block of a
    sequence-parallel residual, so the replicated ``w``'s gradient, the
    rank's tokens' part, is summed over the model axis."""
    return rms_norm(x, tp.sum_grad(w, sp), eps)


def init_moe(gen: torch.Generator, cfg: ModelConfig, pdt) -> Params:
    """Router [d, E] in float32 and expert weights [E, ...] over the padded
    expert count (padded experts never receive a token)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    return {
        "router": dense_init(gen, (d, e), F32),
        "wg": dense_init(gen, (e, d, f), pdt),
        "wi": dense_init(gen, (e, d, f), pdt),
        "wo": dense_init(gen, (e, f, d), pdt),
    }


def moe_route(p: Params, x, cfg: ModelConfig):
    """(topw [B,S,K] float32, topi [B,S,K]) of ``x`` [B,S,d]: the router
    product in float32, padded experts at -1e30 before the softmax, the
    top k by a stable descending sort (ties to the lower expert index, as
    ``jax.lax.top_k``), weights renormalised by their sum (at least
    1e-9)."""
    e, k = cfg.n_experts_padded, cfg.topk
    logits = x.to(F32) @ p["router"].to(F32)                      # [B,S,E]
    if e > cfg.n_experts:
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :k], topi[..., :k]
    return topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), topi


def _experts(p: Params, xg, cdt):
    """SwiGLU of every expert on its own rows: xg [G,E,C,d] -> [G,E,C,d].
    Expert weights cut over the experts on the model axis (expert
    parallelism's layout, met by a decode step or a prefill whose shapes
    do not tile the mesh) run this rank's experts on their buffers and
    all-gather the outputs over the experts (exact: one rank computes
    each expert), as GSPMD partitions the reference's ``expert_in`` /
    ``expert_out`` constraints; other DTensor expert weights are
    gathered first."""
    ax = tp.axis_of(p["wg"])
    parts = [tp.part(p[n]) for n in ("wg", "wi", "wo")]
    if ax is not None and all(d == 0 for _, d, _ in parts):
        wg, wi, wo = (w.to(cdt) for w, _, _ in parts)
        xg = tp.block(xg, 1, ax)
    else:
        wg, wi, wo = (shd.full(p[n]).to(cdt) for n in ("wg", "wi", "wo"))
        ax = None
    h = torch.einsum("gecd,edf->gecf", xg, wg)
    u = torch.einsum("gecd,edf->gecf", xg, wi)
    return tp.gather(torch.einsum("gecf,efd->gecd", F.silu(h) * u, wo), 1,
                     ax)


def moe_forward(p: Params, x, cfg: ModelConfig, sp=None):
    """Top-k MoE FFN.  x: [B,S,d] -> [B,S,d]; ``cfg.moe_mode`` ``dense``
    (every expert computes every token, combined with the sparse gate
    weights: the correctness oracle) or ``dispatch`` (sort-based capacity
    dispatch over ``moe_groups`` groups of the sequence).  With ``sp``
    ``x`` is the rank's block of a sequence-parallel residual, which the
    expert-parallel path takes as its ``shard_map`` does."""
    if sp is not None:
        rules = shd.current_rules()
        if cfg.moe_mode != "dense":
            # the router on the rank's tokens: its gradient a part
            topw, topi = moe_route({"router": tp.sum_grad(p["router"], sp)},
                                   x, cfg)
            out = _moe_shardmap(p, x, topi, topw.to(x.dtype), cfg, rules,
                                seq_local=True)
            if out is not None:
                return out
        # every token on every rank: a replicated activation, its
        # gradient whole (a plain gather's backward, the slice)
        return tp.block(moe_forward(p, tp.gather(x, 1, sp), cfg), 1,
                        sp).contiguous()
    b, s, d = x.shape
    e, k = cfg.n_experts_padded, cfg.topk
    cdt = x.dtype
    topw, topi = moe_route(p, x, cfg)
    if cfg.moe_mode == "dense":
        y = _experts(p, x.reshape(1, 1, b * s, d).expand(1, e, b * s, d),
                     cdt)[0]                                      # [E,BS,d]
        dense_w = torch.zeros((b * s, e), dtype=F32, device=x.device)
        dense_w.scatter_add_(1, topi.reshape(b * s, k),
                             topw.reshape(b * s, k))
        out = torch.einsum("etd,te->td", y, dense_w.to(cdt))
        return out.reshape(b, s, d)
    rules = shd.current_rules()
    if rules is not None and s > 1:
        out = _moe_shardmap(p, x, topi, topw.to(cdt), cfg, rules)
        if out is not None:
            return out
    g = cfg.moe_groups if s % cfg.moe_groups == 0 and s >= cfg.moe_groups \
        else 1
    tg = s // g
    out = _moe_dispatch_batched(x.reshape(b * g, tg, d),
                                topi.reshape(b * g, tg, k),
                                topw.reshape(b * g, tg, k).to(cdt), p, cfg)
    return out.reshape(b, s, d)


def moe_capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``t`` tokens:
    max(4, min(ceil(t k / E * capacity_factor), t))."""
    cap = int(math.ceil(t * cfg.topk / cfg.n_experts_padded
                        * cfg.capacity_factor))
    return max(4, min(cap, t))


def dispatch_plan(ti, e: int, cap: int):
    """The capacity dispatch of expert choices ``ti`` [G,T,K]:
    (buf_idx [G, E*cap], the token row of each expert slot — ``T``, the
    zero row, where the slot is empty — and bp [G, T*K], the slot each
    (token, choice) landed in — ``E*cap``, the zero row, where it was
    dropped).  Choices are ordered by a stable sort on the expert id, so
    an expert's first ``cap`` choices in token order keep their slots."""
    gdim, t, k = ti.shape
    tk = t * k
    dev = ti.device
    flat_e = ti.reshape(gdim, tk)
    flat_row = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=1, stable=True)            # [G,TK]
    e_sorted = torch.gather(flat_e, 1, order)
    row_sorted = flat_row[order]
    counts = torch.zeros((gdim, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, dim=1) - counts                 # [G,E]
    slot = torch.arange(cap, device=dev)
    s_pos = torch.clamp(start[:, :, None] + slot, max=tk - 1)
    valid = slot < torch.clamp(counts, max=cap)[:, :, None]      # [G,E,cap]
    buf_idx = torch.where(
        valid, torch.gather(row_sorted, 1, s_pos.reshape(gdim, e * cap))
        .reshape(gdim, e, cap), t).reshape(gdim, e * cap)
    pos_in_e = torch.arange(tk, device=dev) - torch.gather(start, 1, e_sorted)
    bp_sorted = torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e, e * cap)
    bp = torch.empty_like(bp_sorted).scatter_(1, order, bp_sorted)
    return buf_idx, bp


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of ``x`` [M, ...] over ``group`` (chunk i to
    rank i, chunk i of the result from rank i); its backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    # contiguous first: ``empty_like`` keeps a view's strides, and the
    # collective fills the buffer in memory order
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _moe_shardmap(p: Params, x, topi, topw, cfg: ModelConfig, rules,
                  seq_local: bool = False):
    """Explicit EP over (data axes x model); None when the shapes do not
    tile the mesh (the caller takes the pure path).  ``seq_local``: ``x``
    already holds this rank's block of the sequence (a sequence-parallel
    residual, the reference's ``in_specs`` ``P(dp, model, None)``)."""
    from torch.distributed.tensor import DTensor

    b, s, d = x.shape
    e, k = cfg.n_experts_padded, cfg.topk
    mesh, maxis = rules.mesh, rules.model_axis
    m = shd.axis_size(mesh, maxis)
    # a data-parallel step's activations are already this rank's rows
    dp_size = 1 if rules.local_batch else shd.mesh_size(mesh, rules.dp)
    experts = [p[n] for n in ("wg", "wi", "wo")]
    ep = shd.placements((maxis, None, None), mesh)
    if b % dp_size or (s % m and not seq_local) or e % m or not all(
            isinstance(w, DTensor) and tuple(w.placements) == ep
            for w in experts):
        return None
    t_loc = (b // dp_size) * (s if seq_local else s // m)
    cap = max(4, int(math.ceil(t_loc * k / e * cfg.capacity_factor)))
    e_loc = e // m
    cdt = x.dtype
    blk = shd.placements((None if rules.local_batch else rules.dp,
                          None if seq_local else maxis, None), mesh)
    # this rank's block of tokens (batch over the data axes, sequence over
    # the model axis), cut from the replicated activations (the sequence
    # already cut when ``seq_local``)
    xl, twl = shd.scatter(x, mesh, blk), shd.scatter(topw, mesh, blk)
    til = shd.local_slice(topi, mesh, blk)
    bl, sl = xl.shape[:2]
    # the local experts; the data ranks ran them on other tokens, so their
    # gradient sums over the data axes (shard_map's transpose of an input
    # that is replicated over them) — in a data-parallel step the
    # optimizer sums every gradient over them instead
    wg, wi, wo = (w.to_local().to(cdt) if rules.local_batch else
                  shd.sum_grad(w.to_local(), mesh, rules.data_axes).to(cdt)
                  for w in experts)
    group = mesh.get_group(maxis)

    def expert_fn(xg):
        # xg: [1, E, cap, d], every expert's local buffer -> each rank
        # keeps its E_loc experts' buffers from every peer
        recv = _AllToAll.apply(xg.reshape(m, e_loc, cap, d), group)
        recv = recv.transpose(0, 1).reshape(e_loc, m * cap, d)
        h = torch.einsum("ecd,edf->ecf", recv, wg)
        u = torch.einsum("ecd,edf->ecf", recv, wi)
        yg = torch.einsum("ecf,efd->ecd", F.silu(h) * u, wo)
        back = yg.reshape(e_loc, m, cap, d).transpose(0, 1).contiguous()
        back = _AllToAll.apply(back, group)               # [M,E_loc,cap,d]
        return back.reshape(1, e, cap, d)

    out = _moe_dispatch_batched(xl.reshape(1, bl * sl, d),
                                til.reshape(1, bl * sl, k),
                                twl.reshape(1, bl * sl, k), p, cfg,
                                expert_fn=expert_fn, cap_override=cap)
    return shd.gather(out.reshape(bl, sl, d), mesh, blk)


def _moe_dispatch_batched(xf, ti, tw, p: Params, cfg: ModelConfig, *,
                          expert_fn=None, cap_override=None):
    """Batched capacity dispatch.  xf: [G,T,d]; ti/tw: [G,T,K].  Each
    group's token rows are gathered into [E, cap] expert buffers, the
    experts run batched (``expert_fn`` of the buffers [G,E,cap,d] when
    given: the EP path's exchange), and each (token, choice) gathers its
    slot back (a dropped one the zero row), weighted by its gate.
    ``cap_override`` replaces :func:`moe_capacity`."""
    gdim, t, d = xf.shape
    e, k = cfg.n_experts_padded, cfg.topk
    cdt = xf.dtype
    cap = cap_override if cap_override is not None else moe_capacity(t, cfg)
    buf_idx, bp = dispatch_plan(ti, e, cap)
    zero = xf.new_zeros((gdim, 1, d))
    x_pad = torch.cat([xf, zero], dim=1)
    xg = torch.gather(x_pad, 1, buf_idx[..., None].expand(-1, -1, d))
    xg = xg.reshape(gdim, e, cap, d)
    yg = expert_fn(xg) if expert_fn is not None else _experts(p, xg, cdt)
    yg_pad = torch.cat([yg.reshape(gdim, e * cap, d), zero], dim=1)
    contrib = torch.gather(yg_pad, 1, bp[..., None].expand(-1, -1, d))
    return torch.einsum("gtkd,gtk->gtd", contrib.reshape(gdim, t, k, d),
                        tw.to(cdt))
