"""Zamba2-style hybrid LM in PyTorch — the port of the JAX package's
``repro.models.hybrid`` (zamba2-7b): a Mamba2 backbone with *shared*
attention blocks.

``cfg.n_layers`` Mamba2 blocks run in segments of ``cfg.shared_every``;
after each *full* segment one of ``cfg.n_shared`` alternating shared
transformer blocks (full attention and a SwiGLU MLP, weights reused) is
applied: block ``i % n_shared`` at application ``i``.  Each application
keeps its own KV cache, since its inputs differ with depth.  As in the
JAX package the weights are shared exactly (no per-application LoRA
deltas of the released checkpoints).

Parameters are ``{"embed", "layers": [{"m", "ln"}, ...], "shared":
[{"attn", "mlp", "ln1", "ln2"}, ...], "final_norm", "unembed"}``; the
cache keeps the JAX layout: ``state`` [L, B, H, P, N] float32, ``conv``
[L, B, W-1, conv_dim], ``k``/``v`` [n_apps, B, Smax, Hkv, D] and
``len``.  The prefill runs each Mamba block's scan through the SSD kernel
(``ssm.mamba_forward``) and each shared application's causal attention
through the flash-attention kernel: ``n_layers`` SSD calls and
``n_layers // shared_every`` flash launches a prefill, under
``torch.no_grad()``.  ``forward`` and ``loss`` reach no kernel: the
differentiable ``ssm.ssd_chunked`` (each Mamba block under
``transformer._remat``, as in the JAX package) and plain attention
(``layers.attn_forward``).  Decode is plain torch (``ssm.mamba_step``,
``layers.attn_decode_forward``).

On a device mesh the parameters are DTensors: ``forward`` (tests)
gathers them at its entry (``distributed.sharding.unshard``) and runs the
blocks on plain tensors.  ``loss``, ``prefill`` and ``decode_step``
compute tensor-parallel over ``model`` on the parameters' shards
(``distributed.tp``; ``models.ssm.mamba_forward``), the prefill's
residual sequence-parallel under mesh rules (the train step's too). The shared blocks are
tensor-parallel as ``models.transformer``'s, the Mamba blocks as
``models.mamba_lm``'s.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import unshard
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.mamba_lm import ssm_cache
from repro_torch.models.transformer import _remat, lm_loss

F32 = torch.float32
Params = Dict[str, Any]


def _segments(cfg: ModelConfig) -> List[int]:
    """Mamba blocks per segment: full ``shared_every`` segments, then the
    remainder (which no shared block follows)."""
    full, rem = divmod(cfg.n_layers, cfg.shared_every)
    return [cfg.shared_every] * full + ([rem] if rem else [])


def _n_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_every


class Zamba2LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)

    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn from ``gen`` on its device."""
        cfg = self.cfg
        zeros = lambda: L.zeros(gen, (cfg.d_model,), self.pdt)  # noqa: E731
        return {
            "embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  self.pdt),
            "layers": [{"m": ssm.init_mamba_block(gen, cfg, self.pdt),
                        "ln": zeros()} for _ in range(cfg.n_layers)],
            "shared": [{"attn": L.init_attn(gen, cfg, self.pdt),
                        "mlp": L.init_mlp(gen, cfg, self.pdt),
                        "ln1": zeros(), "ln2": zeros()}
                       for _ in range(cfg.n_shared)],
            "final_norm": zeros(),
            "unembed": L.dense_init(gen, (cfg.d_model, cfg.vocab_padded),
                                    self.pdt),
        }

    def _embed(self, params, tokens):
        return tp.embed(params["embed"], tokens, self.cdt)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return tp.logits(x, params["unembed"], 1)

    def _mlp(self, shared, x, sp=None):
        return L.mlp_residual(shared["mlp"], shared["ln2"], x,
                              self.cfg.norm_eps, sp)

    def _apps(self, params):
        """(segment's first layer, its size, shared block or None) in
        order."""
        cfg = self.cfg
        start = 0
        for i, size in enumerate(_segments(cfg)):
            sp = params["shared"][i % cfg.n_shared] \
                if size == cfg.shared_every else None
            yield start, size, sp
            start += size

    # ---------------- forward / train ----------------
    def _body(self, params, batch, seq=None):
        """Every segment: its Mamba blocks (``ssd_chunked``, each under
        ``_remat``), then its shared block (plain attention); with ``seq``
        the residual is sequence-parallel (the rank's block returned)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = tp.block(x, 1, seq)

        def mblock(h, lp):
            return h + ssm.mamba_forward(
                lp["m"], tp.gather_seq(L.seq_norm(h, lp["ln"], cfg.norm_eps,
                                                  seq), seq), cfg,
                kernel=False, sp=seq)

        mblock = _remat(mblock, cfg)
        for start, size, sp in self._apps(params):
            for lp in params["layers"][start:start + size]:
                x = mblock(x, lp)
            if sp is not None:
                hn = tp.gather_seq(L.seq_norm(x, sp["ln1"], cfg.norm_eps,
                                              seq), seq)
                x = x + L.attn_forward(sp["attn"], hn, cfg, positions,
                                       causal=True, sp=seq)
                x = self._mlp(sp, x, seq)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Full logits [B, S, V] (small inputs only; tests)."""
        params = unshard(params)
        return self._logits(params, self._body(params, batch))

    def loss(self, params, batch, count=None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Mean next-token cross-entropy -> (loss, {"loss", "tokens"}), on
        the parameters' shards (``models.transformer.TransformerLM.loss``
        says how)."""
        params = tp.localize(params)
        seq = tp.seq_axis(batch["tokens"].shape[1])
        return lm_loss(self._body(params, batch, seq), params["unembed"],
                       params["final_norm"], batch, self.cfg.norm_eps, count,
                       sp=seq)

    # ---------------- serve ----------------
    def cache_spec(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """{name: (shape, dtype)} of the decode cache (``len`` an int)."""
        cfg = self.cfg
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        kv = ((_n_apps(cfg), batch_size, max_len, cfg.n_kv_heads,
               cfg.head_dim), self.cdt)
        return {
            "state": ((cfg.n_layers, batch_size, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_state), F32),
            "conv": ((cfg.n_layers, batch_size, cfg.ssm_conv - 1, conv_dim),
                     self.cdt),
            "k": kv, "v": kv, "len": ((), torch.int64),
        }

    def init_cache(self, batch_size: int, max_len: int,
                   device: DeviceLike = None) -> Params:
        """Zeroed decode cache on ``device`` (``cuda`` unless asked)."""
        return L.zero_cache(self.cache_spec(batch_size, max_len),
                            resolve_device(device))

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None) -> Tuple[torch.Tensor,
                                                           Params]:
        """Last-token logits [B, V] and the cache: every Mamba block's SSD
        state and conv history, every shared application's K/V (padded to
        ``max_len`` positions)."""
        cfg = self.cfg
        mesh = tp.mesh_of(params)
        params = tp.localize(params)
        x = self._embed(params, batch["tokens"])
        s = x.shape[1]
        seq = tp.seq_axis(s)
        x = tp.block(x, 1, seq)
        positions = torch.arange(s, device=x.device)[None, :]
        states, convs, ks, vs = [], [], [], []
        for start, size, sp in self._apps(params):
            for lp in params["layers"][start:start + size]:
                y, st, conv = ssm.mamba_forward(
                    lp["m"], tp.gather_seq(L.rms_norm(x, lp["ln"],
                                                      cfg.norm_eps), seq),
                    cfg, return_cache=True, sp=seq)
                x = x + y
                states.append(st)
                convs.append(conv)
            if sp is not None:
                o, k, v = L.flash_attn(
                    sp["attn"], tp.gather_seq(L.rms_norm(x, sp["ln1"],
                                                         cfg.norm_eps), seq),
                    cfg, positions, causal=True, sp=seq)
                x = self._mlp(sp, x + o, seq)
                ks.append(k)
                vs.append(v)
        k_all, v_all = L.stack_kv(ks, vs, max_len)
        logits = self._logits(params, tp.last_token(x, seq))[:, 0]
        return logits, {**ssm_cache(cfg, mesh, states, convs), "k": k_all,
                        "v": v_all, "len": s}

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache with ``len`` + 1).  The
        cache's buffers are updated in place (``ServeEngine.decode`` works
        on a copy).  A cache laid out by ``launch.specs`` decodes each
        rank's rows, the shared attention against its slice of the KV
        sequence (``layers.decode_inputs``)."""
        cfg = self.cfg
        params = tp.localize(params)
        loc, tokens, seq, wrap = L.decode_inputs(cache, tokens)
        x = self._embed(params, tokens)[:, None]
        clen = int(cache["len"])
        app = 0
        for start, size, sp in self._apps(params):
            for i in range(start, start + size):
                lp = params["layers"][i]
                y, st, conv = ssm.mamba_step(
                    lp["m"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                    loc["state"][i], loc["conv"][i])
                x = x + y
                loc["state"][i] = st
                loc["conv"][i] = conv
            if sp is not None:
                hn = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
                x = x + L.attn_decode_forward(sp["attn"], hn, cfg,
                                              loc["k"][app], loc["v"][app],
                                              clen, seq)
                x = self._mlp(sp, x)
                app += 1
        return wrap(self._logits(params, x)[:, 0]), {**cache,
                                                     "len": clen + 1}
