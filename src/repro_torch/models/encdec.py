"""Encoder-decoder transformer LM in PyTorch — the port of the JAX
package's ``repro.models.encdec`` (seamless-m4t-medium).

The speech frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``frames`` [B, Se, d], projects them
(``frame_proj``), runs ``enc_layers`` bidirectional blocks and ends with
``enc_norm``; the decoder's ``n_layers`` blocks each hold causal
self-attention, cross-attention to the encoder states (no rotary on its
q or k) and a SwiGLU MLP.

Parameters are ``{"frame_proj", "enc_layers": [...], "embed",
"dec_layers": [...], "enc_norm", "final_norm", "unembed"}``; the cache
keeps the JAX layout: ``k``/``v`` [L, B, Smax, Hkv, D], the cross
``ck``/``cv`` [L, B, Se, Hkv, D] and ``len``.  The prefill sends every
attention through the flash-attention kernel: the encoder's
self-attention (non-causal), the decoder's self-attention (causal) and
its cross-attention (non-causal, Sq = the prompt, Sk = the frames), so
``enc_layers + 2 * n_layers`` launches a prefill, under
``torch.no_grad()``.  ``forward`` and ``loss`` reach no kernel: they keep
the JAX package's plain, differentiable attention in the encoder
(``encode(kernel=False)``) and the decoder, each block under
``transformer._remat``.  Decode is plain torch, its cross-attention over
the whole of ``ck``/``cv``.

On a device mesh the parameters are DTensors: ``forward`` (tests)
gathers them at its entry (``distributed.sharding.unshard``) and runs the
blocks on plain tensors.  ``loss``, ``prefill`` and ``decode_step``
compute tensor-parallel over ``model`` on the parameters' shards
(``distributed.tp``; ``models.ssm.mamba_forward``), the prefill's
residual sequence-parallel under mesh rules (the train step's too). The encoder's residual is
sequence-parallel over its frames, the decoder's over its prompt; the
cross K/V are whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import unshard
from repro_torch.models import layers as L
from repro_torch.models.transformer import _remat, lm_loss

F32 = torch.float32
Params = Dict[str, Any]


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)

    # ---------------- params ----------------
    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn from ``gen`` on its device."""
        cfg = self.cfg
        zeros = lambda: L.zeros(gen, (cfg.d_model,), self.pdt)  # noqa: E731
        return {
            "frame_proj": L.dense_init(gen, (cfg.d_model, cfg.d_model),
                                       self.pdt),
            "enc_layers": [{"attn": L.init_attn(gen, cfg, self.pdt),
                            "mlp": L.init_mlp(gen, cfg, self.pdt),
                            "ln1": zeros(), "ln2": zeros()}
                           for _ in range(cfg.enc_layers)],
            "embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  self.pdt),
            "dec_layers": [{"attn": L.init_attn(gen, cfg, self.pdt),
                            "cross": L.init_attn(gen, cfg, self.pdt),
                            "mlp": L.init_mlp(gen, cfg, self.pdt),
                            "ln1": zeros(), "ln2": zeros(), "ln3": zeros()}
                           for _ in range(cfg.n_layers)],
            "enc_norm": zeros(),
            "final_norm": zeros(),
            "unembed": L.dense_init(gen, (cfg.d_model, cfg.vocab_padded),
                                    self.pdt),
        }

    def _embed(self, params, tokens):
        return tp.embed(params["embed"], tokens, self.cdt)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return tp.logits(x, params["unembed"], 1)

    def _mlp(self, lp, x, ln: str, sp=None):
        return L.mlp_residual(lp["mlp"], lp[ln], x, self.cfg.norm_eps, sp)

    # ---------------- encoder ----------------
    def encode(self, params, frames, *, kernel: bool = True
               ) -> torch.Tensor:
        """Encoder states [B, Se, d] of ``frames`` [B, Se, d].  Each layer's
        bidirectional self-attention goes through the flash kernel (the
        serve path), or with ``kernel=False`` through the differentiable
        ``layers.attn_forward``, each block under ``_remat`` (the JAX
        package's ``encode``)."""
        cfg = self.cfg
        x = frames.to(self.cdt) @ params["frame_proj"].to(self.cdt)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        sp = tp.seq_axis(x.shape[1])
        x = tp.block(x, 1, sp)

        def block(h, lp):
            hn = tp.gather_seq(L.seq_norm(h, lp["ln1"], cfg.norm_eps, sp), sp)
            if kernel:
                o, _, _ = L.flash_attn(lp["attn"], hn, cfg, positions,
                                       causal=False, sp=sp)
            else:
                o = L.attn_forward(lp["attn"], hn, cfg, positions,
                                   causal=False, sp=sp)
            return self._mlp(lp, h + o, "ln2", sp)

        if not kernel:
            block = _remat(block, cfg)
        for lp in params["enc_layers"]:
            x = block(x, lp)
        return tp.gather_seq(L.seq_norm(x, params["enc_norm"], cfg.norm_eps,
                                        sp), sp)

    # ---------------- forward / train ----------------
    def _body(self, params, batch, sp=None):
        """Encoder and decoder (plain attention, each block under
        ``_remat``): the decoder's output [B, S, d] before the final norm
        (with ``sp`` the rank's block of its sequence-parallel
        residual)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"], kernel=False)
        enc_sp = tp.seq_axis(batch["frames"].shape[1])
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = tp.block(x, 1, sp)

        def block(h, lp):
            hn = tp.gather_seq(L.seq_norm(h, lp["ln1"], cfg.norm_eps, sp), sp)
            h = h + L.attn_forward(lp["attn"], hn, cfg, positions,
                                   causal=True, sp=sp)
            hn = tp.gather_seq(L.seq_norm(h, lp["ln2"], cfg.norm_eps, sp), sp)
            h = h + L.attn_forward(lp["cross"], hn, cfg, positions,
                                   causal=False, kv_override=enc, sp=sp,
                                   kv_sp=enc_sp)
            return self._mlp(lp, h, "ln3", sp)

        block = _remat(block, cfg)
        for lp in params["dec_layers"]:
            x = block(x, lp)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Full logits [B, S, V] (small inputs only; tests)."""
        params = unshard(params)
        return self._logits(params, self._body(params, batch))

    def loss(self, params, batch, count=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Mean next-token cross-entropy of the decoder's tokens given the
        ``frames`` -> (loss, {"loss", "tokens"}), on the parameters'
        shards (``models.transformer.TransformerLM.loss`` says how; the
        encoder's residual is sequence-parallel over its frames, the
        decoder's over its tokens)."""
        params = tp.localize(params)
        sp = tp.seq_axis(batch["tokens"].shape[1])
        return lm_loss(self._body(params, batch, sp), params["unembed"],
                       params["final_norm"], batch, self.cfg.norm_eps, count,
                       sp=sp)

    # ---------------- serve ----------------
    def cache_spec(self, batch_size: int, max_len: int,
                   enc_len: int) -> Dict[str, Any]:
        """{name: (shape, dtype)} of the decode cache (``len`` an int)."""
        cfg = self.cfg
        tail = (cfg.n_kv_heads, cfg.head_dim)
        kv = ((cfg.n_layers, batch_size, max_len) + tail, self.cdt)
        ckv = ((cfg.n_layers, batch_size, enc_len) + tail, self.cdt)
        return {"k": kv, "v": kv, "ck": ckv, "cv": ckv,
                "len": ((), torch.int64)}

    def init_cache(self, batch_size: int, max_len: int, enc_len: int,
                   device: DeviceLike = None) -> Params:
        """Zeroed decode cache on ``device`` (``cuda`` unless asked)."""
        return L.zero_cache(self.cache_spec(batch_size, max_len, enc_len),
                            resolve_device(device))

    def prefill_cross(self, params, enc) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K/V [L, B, Se, Hkv, D] of the
        encoder states ``enc``."""
        kvs = [L.cross_kv(lp["cross"], enc.to(self.cdt), self.cfg)
               for lp in params["dec_layers"]]
        return (torch.stack([k for k, _ in kvs]),
                torch.stack([v for _, v in kvs]))

    @torch.no_grad()
    def prefill(self, params, batch, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Encoder pass, the cross K/V, then the decoder's prompt: last-token
        logits [B, V] and the cache (self K/V padded to ``max_len``)."""
        cfg = self.cfg
        params = tp.localize(params)
        enc = self.encode(params, batch["frames"])
        ck, cv = self.prefill_cross(params, enc)
        x = self._embed(params, batch["tokens"])
        s = x.shape[1]
        sp = tp.seq_axis(s)
        x = tp.block(x, 1, sp)
        positions = torch.arange(s, device=x.device)[None, :]
        ks, vs = [], []
        for lp, ckl, cvl in zip(params["dec_layers"], ck, cv):
            o, k, v = L.flash_attn(
                lp["attn"], tp.gather_seq(L.rms_norm(x, lp["ln1"],
                                                     cfg.norm_eps), sp),
                cfg, positions, causal=True, sp=sp)
            x = x + o
            co, _, _ = L.flash_attn(
                lp["cross"], tp.gather_seq(L.rms_norm(x, lp["ln2"],
                                                      cfg.norm_eps), sp),
                cfg, None, causal=False, kv=(ckl, cvl), sp=sp)
            x = self._mlp(lp, x + co, "ln3", sp)
            ks.append(k)
            vs.append(v)
        logits = self._logits(params, tp.last_token(x, sp))[:, 0]
        k_all, v_all = L.stack_kv(ks, vs, max_len)
        return logits, {"k": k_all, "v": v_all, "ck": ck, "cv": cv,
                        "len": s}

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache with ``len`` + 1).  The new
        token's self K/V are written into the cache in place
        (``ServeEngine.decode`` works on a copy); cross-attention reads the
        whole of ``ck``/``cv``.  A cache laid out by ``launch.specs``
        decodes as ``TransformerLM.decode_step`` does, cross attention
        over this rank's slice of ``ck``/``cv`` with no length mask."""
        cfg = self.cfg
        params = tp.localize(params)
        loc, tokens, seq, wrap = L.decode_inputs(cache, tokens)
        x = self._embed(params, tokens)[:, None]
        clen = int(cache["len"])
        b = x.shape[0]
        for i, lp in enumerate(params["dec_layers"]):
            hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + L.attn_decode_forward(lp["attn"], hn, cfg, loc["k"][i],
                                          loc["v"][i], clen, seq)
            hn2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            q = tp.col_full(hn2, lp["cross"]["wq"]).reshape(
                b, 1, cfg.n_heads, cfg.head_dim)
            ck, cv = loc["ck"][i], loc["cv"][i]
            enc_len = ck.shape[1] * (seq.parts if seq is not None else 1)
            co = L.attention_decode(q, ck.to(x.dtype), cv.to(x.dtype),
                                    enc_len, seq)
            x = x + tp.row(co.reshape(b, 1, -1), lp["cross"]["wo"])
            x = self._mlp(lp, x, "ln3")
        return wrap(self._logits(params, x)[:, 0]), {**cache,
                                                     "len": clen + 1}
