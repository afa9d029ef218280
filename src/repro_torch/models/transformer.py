"""Decoder-only transformer LM in PyTorch — the port of the JAX package's
``repro.models.transformer``: the ``dense`` family (smollm-135m and the
other GQA llama-style configs), ``moe`` (granite-moe-3b-a800m,
qwen3-moe-30b-a3b: every layer's FFN through ``layers.moe_forward``) and
``vlm`` (internvl2-1b: precomputed patch embeddings, projected by
``patch_proj``, go before the tokens).

Parameters are ``{"embed", "layers": [per-layer dict, ...],
"final_norm"[, "unembed"][, "patch_proj"]}`` (the JAX package stacks
``layers`` along a leading ``L`` dimension;
``models.convert.params_from_jax`` unstacks).  Caches keep the JAX
layout: ``k``/``v`` [L, B, Smax, Hkv, D] and ``len`` (an int here, a
scalar array there); for ``vlm`` the positions count the patches too.

The causal prefill sends its attention through the flash-attention kernel
(``kernels.flash_attention``: the CUDA kernel on the card, its plain
version on the CPU), one launch per layer, under ``torch.no_grad()``.
``forward`` and ``loss`` keep the JAX package's plain, differentiable
attention (``layers.attn_forward``) and reach no kernel, and decode
attends with plain torch (``layers.attention_decode``: one query against
the cache; the kernel's causal mask assumes query and key positions both
start at 0).

Training (``loss``): each block runs under ``_remat`` (``cfg.remat``:
``none``, ``full`` activation checkpointing, or ``dots``, which saves the
activation x weight products and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable``), and ``chunked_ce_loss`` takes the
cross-entropy one sequence chunk at a time, each chunk checkpointed, as
``src/repro/models/transformer.py:23-63`` does.

On a device mesh (``distributed.sharding``; ``launch.train --mesh
elastic``) the parameters are DTensors.  ``loss``, ``prefill`` and
``decode_step`` compute tensor-parallel over ``model`` on the parameters'
shards (``distributed.tp``, as the reference's GSPMD does from the same
specs): the embedding and head vocab-parallel (the loss's cross-entropy
on the rank's block of the vocabulary), q/k/v and the MLP's gate
column-parallel, ``wo`` row-parallel (attention on the rank's heads
where the model axis divides Hq), and under mesh rules with
``seq_parallel`` the residual sequence-parallel between blocks (the
reference's ``shard_activation`` sites), the MoE block taking its
sequence block as expert parallelism's input; the train step's backward
runs through the collectives' own.  ``forward`` (tests) gathers each
parameter at its entry (``sharding.unshard``), the MoE expert weights
kept sharded for expert parallelism (``layers._moe_shardmap``).  A batch laid out over the data axes gives each rank its rows
(``optim.loss_and_grads`` passes the global token ``count`` to
``loss``), and a decode cache laid out by ``launch.specs`` attends over
the rank's slice of the KV sequence (``layers.decode_inputs``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import is_moe_expert, unshard
from repro_torch.models import layers as L

F32 = torch.float32
Params = Dict[str, Any]

#: what ``remat="dots"`` saves: the products of a batch of activations and
#: a weight matrix (2-D products; the batched ``bmm`` of attention and of
#: the MoE experts is recomputed, as JAX's
#: ``dots_with_no_batch_dims_saveable`` recomputes batched dot_generals)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``none`` as it is; ``dots`` checkpointed
    saving only the ``mm``/``addmm`` outputs; anything else (``full``)
    checkpointed whole (non-reentrant)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def chunked_ce_loss(x, head, labels, mask, *, chunk: int = 512,
                    norm_w=None, eps: float = 1e-5, count=None,
                    vocab_dim: int = 1, sp=None):
    """Memory-bounded cross-entropy over sequence chunks (``chunk`` at most
    S, halved until it divides S), each chunk checkpointed so that no more
    than one chunk's [B, chunk, V] logits live at once (and its
    collectives recomputed in the same order on every rank).

    x: [B,S',d] before the final norm (applied per chunk with
    ``norm_w``), its last S positions scored; head: the unembedding
    [d,V] (``vocab_dim`` 1) or a tied embedding [V,d] (``vocab_dim`` 0);
    labels/mask: [B,S].  Logits in float32, logsumexp minus the gold
    logit, times the mask.  Returns (mean loss, tokens): the masked sum
    over the mask's count, or over ``count`` when given (a data-parallel
    step's global token count; ``tokens`` stays this batch's).

    A head cut over the vocabulary on the model axis (``distributed.tp``)
    gives the rank's [B, chunk, V/m] logits: the max all-reduced (MAX),
    the sum of exponentials and the gold logit, from the rank that owns
    the label, all-reduced (SUM) in float32; the normed input enters them
    through a float32 all-reduce of its gradient.  With ``sp`` ``x`` is
    the rank's block of a sequence-parallel residual: the norm runs on it
    (its weight's gradient summed over the model axis) and the whole
    sequence is gathered (``tp.gather_seq``, whose reduce-scatter sums
    the input gradient)."""
    wl, dim, ax = tp.part(head)
    if dim is not None and dim != vocab_dim:
        raise ValueError("the loss head is cut over d_model; the rules cut "
                         "it over the vocabulary or leave it whole")
    cut = ax if dim is not None else None
    head = wl.T if vocab_dim == 0 else wl
    if sp is not None:
        x = tp.gather_seq(L.seq_norm(x, norm_w, eps, sp), sp)
        x, norm_w = (x if cut is not None else tp.own(x, sp)), None
    x = x[:, x.shape[1] - labels.shape[1]:]
    s = x.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2

    def body(xi, li, mi):
        if norm_w is not None:
            xi = L.rms_norm(xi, norm_w, eps)
        if cut is None:
            logits = (xi @ head.to(xi.dtype)).to(F32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        else:
            if sp is None:
                xi = tp.sum_grad(xi, cut)
            logits = (xi @ head.to(xi.dtype)).to(F32)
            lse, gold = _vocab_parallel_lse_gold(logits, li, cut)
        return ((lse - gold) * mi).sum(), mi.sum()

    tot = cnt = torch.zeros((), dtype=F32, device=x.device)
    for i in range(0, s, chunk):
        nll, n = checkpoint(body, x[:, i:i + chunk], labels[:, i:i + chunk],
                            mask[:, i:i + chunk], use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt if count is None else count, min=1.0), cnt


def _vocab_parallel_lse_gold(logits, labels, ax):
    """(logsumexp, gold logit) over the whole vocabulary from the rank's
    block of it (``logits`` [..., V/m] float32): the max all-reduced
    (MAX, outside the gradient: it cancels), the sum of exponentials and
    the label's logit — the owning rank's, the others adding 0 —
    all-reduced in float32 (their backward the identity, so the logits'
    gradient is the local softmax minus the local one-hot)."""
    n = logits.shape[-1]
    mx = logits.detach().amax(dim=-1, keepdim=True).contiguous()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=ax.group)
    se = tp.sum_f32(torch.exp(logits - mx).sum(dim=-1), ax)
    idx = labels.long() - ax.rank * n
    mine = (idx >= 0) & (idx < n)
    g = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp.sum_f32(torch.where(mine, g, torch.zeros_like(g)), ax)
    return mx[..., 0] + torch.log(se), gold


def lm_loss(x, head, final_norm, batch, eps: float, count=None, *,
            vocab_dim: int = 1, sp=None):
    """The families' shared loss tail: ``chunked_ce_loss`` of the body's
    output ``x`` (with ``sp`` the rank's block of a sequence-parallel
    residual) against ``batch["labels"]`` (``batch["mask"]``, else all
    ones; over ``count`` tokens when given) -> (loss, {"loss",
    "tokens"})."""
    labels, mask = batch["labels"], batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=F32, device=x.device)
    loss, cnt = chunked_ce_loss(x, head, labels, mask, norm_w=final_norm,
                                eps=eps, count=count, vocab_dim=vocab_dim,
                                sp=sp)
    return loss, {"loss": loss, "tokens": cnt}


class TransformerLM:
    """families: dense | moe | vlm."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerLM runs dense, moe and vlm, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)

    # ---------------- params ----------------
    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn from ``gen`` on its device."""
        cfg = self.cfg
        zeros = lambda: L.zeros(gen, (cfg.d_model,), self.pdt)  # noqa: E731
        ffn = "moe" if cfg.family == "moe" else "mlp"
        init_ffn = L.init_moe if cfg.family == "moe" else L.init_mlp
        params = {
            "embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  self.pdt),
            "layers": [{
                "attn": L.init_attn(gen, cfg, self.pdt),
                "ln1": zeros(),
                "ln2": zeros(),
                ffn: init_ffn(gen, cfg, self.pdt),
            } for _ in range(cfg.n_layers)],
            "final_norm": zeros(),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_padded), self.pdt)
        if cfg.family == "vlm":
            params["patch_proj"] = L.dense_init(
                gen, (cfg.d_model, cfg.d_model), self.pdt)
        return params

    def _head(self, params):
        """(the loss head's weight, its vocabulary dim)."""
        if self.cfg.tie_embeddings:
            return params["embed"], 0
        return params["unembed"], 1

    def _embed(self, params, tokens):
        return tp.embed(params["embed"], tokens, self.cdt)

    def _embed_inputs(self, params, batch):
        """Token embeddings [B,S,d]; for ``vlm`` the projected
        ``patch_embeds`` [B,P,d] go before them ([B,P+S,d])."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.family == "vlm":
            patches = batch["patch_embeds"].to(self.cdt) @ \
                params["patch_proj"].to(self.cdt)
            x = torch.cat([patches, x], dim=1)
        return x

    def _ffn(self, lp, hn, sp=None):
        """The FFN of the normed residual ``hn``, the rank's block of the
        sequence with ``sp`` (MoE takes it so; the MLP gathers it)."""
        if self.cfg.family == "moe":
            return L.moe_forward(lp["moe"], hn, self.cfg, sp)
        return L.mlp_forward(lp["mlp"], tp.gather_seq(hn, sp), sp)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return tp.logits(x, params["embed"], 0)
        return tp.logits(x, params["unembed"], 1)

    # ---------------- forward / train ----------------
    def _body(self, params, x, sp=None):
        """Every layer (plain attention, each block under ``_remat``); with
        ``sp`` ``x`` is the rank's block of a sequence-parallel residual
        of ``s`` positions."""
        cfg = self.cfg
        s = x.shape[1] * (sp.size if sp is not None else 1)
        positions = torch.arange(s, device=x.device)[None, :]

        def block(h, lp):
            hn = tp.gather_seq(L.seq_norm(h, lp["ln1"], cfg.norm_eps, sp), sp)
            h = h + L.attn_forward(lp["attn"], hn, cfg, positions,
                                   causal=True, sp=sp)
            return h + self._ffn(
                lp, L.seq_norm(h, lp["ln2"], cfg.norm_eps, sp), sp)

        block = _remat(block, cfg)
        for lp in params["layers"]:
            x = block(x, lp)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Full logits [B, S, V] (small inputs only; tests)."""
        params = unshard(params, keep=is_moe_expert)
        return self._logits(params,
                            self._body(params, self._embed_inputs(params,
                                                                  batch)))

    def loss(self, params, batch, count=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Mean next-token cross-entropy of ``batch`` (tokens, labels[,
        mask][, patch_embeds]) -> (loss, {"loss", "tokens"}); for ``vlm``
        over the text positions only; the masked sum over ``count`` tokens
        when given (``chunked_ce_loss``).  On the parameters' shards
        (tensor-parallel over ``model``, the residual sequence-parallel
        under mesh rules with ``seq_parallel``)."""
        params = tp.localize(params)
        x = self._embed_inputs(params, batch)
        sp = tp.seq_axis(x.shape[1])
        x = self._body(params, tp.block(x, 1, sp), sp)
        head, vdim = self._head(params)
        return lm_loss(x, head, params["final_norm"], batch,
                       self.cfg.norm_eps, count, vocab_dim=vdim, sp=sp)

    # ---------------- serve ----------------
    @torch.no_grad()
    def prefill(self, params, batch, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Process the whole prompt; return last-token logits [B, V] and
        the KV cache (padded to ``max_len`` positions; a ``vlm`` prompt
        holds its patches too, so its ``max_len`` must count them)."""
        cfg = self.cfg
        params = tp.localize(params)
        x = self._embed_inputs(params, batch)
        s = x.shape[1]
        sp = tp.seq_axis(s)
        x = tp.block(x, 1, sp)
        positions = torch.arange(s, device=x.device)[None, :]
        ks, vs = [], []
        for lp in params["layers"]:
            hn = tp.gather_seq(L.rms_norm(x, lp["ln1"], cfg.norm_eps), sp)
            o, k, v = L.flash_attn(lp["attn"], hn, cfg, positions,
                                   causal=True, sp=sp)
            x = x + o
            x = x + self._ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), sp)
            ks.append(k)
            vs.append(v)
        logits = self._logits(params, tp.last_token(x, sp))[:, 0]
        k_all, v_all = L.stack_kv(ks, vs, max_len)
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
        return L.zero_cache(self.cache_spec(batch_size, max_len),
                            resolve_device(device))

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache with ``len`` + 1).  The new
        token's K/V are written into the cache's buffers in place (the JAX
        package returns new arrays; ``ServeEngine.decode`` works on a copy
        so that a caller's cache is left as it was).  A cache and tokens
        laid out by ``launch.specs`` (DTensors) decode each rank's rows
        against its slice of the KV sequence (``layers.decode_inputs``);
        the logits then come back laid out as the tokens."""
        cfg = self.cfg
        params = tp.localize(params)
        loc, tokens, seq, wrap = L.decode_inputs(cache, tokens)
        x = self._embed(params, tokens)[:, None]                  # [B,1,d]
        clen = int(cache["len"])
        for i, lp in enumerate(params["layers"]):
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            if cfg.kv_quant:
                a = _attn_decode_q(lp["attn"], hn, cfg, loc, i, clen, seq)
            else:
                a = L.attn_decode_forward(lp["attn"], hn, cfg, loc["k"][i],
                                          loc["v"][i], clen, seq)
            x = x + a
            x = x + self._ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps))
        logits = self._logits(params, x)[:, 0]
        return wrap(logits), {**cache, "len": clen + 1}


def _attn_decode_q(p, x, cfg: ModelConfig, cache, i: int, clen: int,
                   seq=None):
    """int8-KV decode attention of layer ``i``: the new token's K/V are
    quantised before the write (by the rank whose sequence slice holds
    ``clen``, with ``seq``), the layer's cache — this rank's slice —
    dequantised to read."""
    b = x.shape[0]
    pos = torch.full((b, 1), clen, dtype=torch.int64, device=x.device)
    q, k, v = L.qkv_proj(p, x, cfg, pos)
    at = L.local_position(clen, cache["k"].shape[2], seq)
    if at is not None:
        for name, new in (("k", k), ("v", v)):
            qv, sc = _kv_quantize(new)
            cache[name][i][:, at] = qv[:, 0]
            cache[name + "_s"][i][:, at] = sc[:, 0]
    k_full = _kv_dequantize(cache["k"][i], cache["k_s"][i], x.dtype)
    v_full = _kv_dequantize(cache["v"][i], cache["v_s"][i], x.dtype)
    o = L.attention_decode(q, k_full, v_full, clen + 1, seq)
    return tp.row(o.reshape(b, 1, -1), p["wo"])


def _kv_quantize(x):
    """x: [..., Dh] -> (int8 [..., Dh], float32 absmax scale [...])."""
    xf = x.to(F32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q, scale, dtype):
    return (q.to(F32) * scale[..., None]).to(dtype)
