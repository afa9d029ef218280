"""The published Zamba2 hybrid block in PyTorch (a config with
``hybrid_layer_ids``: zamba2-7b-instruct, Zyphra/Zamba2-7B-Instruct,
arXiv:2411.15242), following transformers' ``modeling_zamba2``
(``Zamba2HybridLayer``) equation for equation.  The JAX package has no
such model; its narrowed block is ``models.hybrid.Zamba2LM``.

``cfg.n_layers`` Mamba2 blocks on a pre-norm residual.  Application j of
the shared blocks runs before the Mamba block of layer
``hybrid_layer_ids[j]``, with shared block ``j % n_shared``
(``Zamba2AttentionDecoderLayer``): the RMS norm of [x, embeddings] (2 d
wide), attention with rotary over the whole head dim and softmax scale
``cfg.softmax_scale``, no residual, the RMS norm of its output, then the
gated MLP ``gelu(g) * u`` whose gate/up product adds application j's own
rank-``adapter_rank`` adapter (``Zamba2MLP``), then application j's own
``linear`` [d, d]; the result is added to the input of that layer's
Mamba norm and not to the residual (``Zamba2MambaDecoderLayer``: x +
mamba(norm(x + t))).  The Mamba blocks run ``cfg.ssm_groups`` B/C groups,
the gated norm per group (``models.ssm``).

Parameters are ``{"embed", "layers": [{"m", "ln"}, ...], "shared":
[{"attn", "mlp", "ln1", "ln2"}, ...], "apps": [{"linear", "adapter_a"
[d, r], "adapter_b" [r, 2 d_ff] (gate's columns, then up's)}, ...],
"final_norm"}`` (and ``"unembed"`` unless ``tie_embeddings``: the head is
the embedding where it is set); the shared blocks' ``ln1`` and q/k/v rows
are 2 d wide.  The cache: ``state`` [L, B, H, P, N] float32, ``conv`` [L,
B, W-1, conv_dim], ``k``/``v`` [n_apps, B, Smax, Hkv, D] in the compute
type, and ``len`` (an int from the prefill, a 0-d int64 tensor on the
device after a decode step).  The prefill runs each Mamba block's scan
through the SSD kernel and each application's causal attention through
the flash kernel, under ``torch.no_grad()``; ``forward`` reaches no
kernel (``ssm.ssd_chunked``, plain attention); decode is plain torch
(``ssm.mamba_step``, ``layers.attn_decode_forward``).  ``decode_step`` on
plain CUDA tensors with autograd off is one CUDA graph replay a token
(``models.decode_graph``, as ``Mamba2LM``'s): the eager body captured once
per input layout, the length read from and advanced in its device tensor,
so that one graph serves every position; every other input runs the eager
body.

Each application runs in a ``shared_block`` span (``repro_torch.tracing``)
and counts ``hybrid.shared_apps`` where the body runs: the prefill, an
eager decode step, and a graph's warm-up and capture; a replay counts
neither (``decode.graph_replays`` counts it).  Each prefill counts
``hybrid.prefills`` and the bytes of the cache it returns,
``hybrid.prefix_kv_bytes`` (k, v) and ``hybrid.prefix_state_bytes``
(state, conv); decode steps count ``decode.graph_captures``,
``decode.graph_replays`` and ``decode.eager_steps`` (``DecodeGraphs``).

Departures from the equations: none.  Of the arithmetic: norms keep the
port's ``(1 + w)`` weight (a published weight w' is 1 + w), and dt is not
clamped at ``time_step_min`` (transformers' plain-torch path clamps it,
its CUDA path and the authors' kernels, ``time_step_limit`` (0, inf), do
not).  The model serves on one device: on a device mesh ``prefill`` and
``decode_step`` raise ``NotImplementedError``, and ``loss`` (no training)
raises on any device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import unshard
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.decode_graph import DecodeGraphs

F32 = torch.float32
Params = Dict[str, Any]


def _one_device(params, what: str) -> None:
    if tp.mesh_of(params) is not None:
        raise NotImplementedError(
            f"the published Zamba2 block's {what} runs on one device: its "
            f"tensor parallelism ([x, embeddings] into the shared block, "
            f"B/C groups) is not implemented")


class Zamba2PublishedLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)
        self._graphs = DecodeGraphs()

    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn from ``gen`` on its device."""
        cfg = self.cfg
        d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
        zeros = lambda n: L.zeros(gen, (n,), self.pdt)  # noqa: E731
        dense = lambda *shape: L.dense_init(gen, shape, self.pdt)  # noqa: E731
        params = {
            "embed": L.embed_init(gen, (cfg.vocab_padded, d), self.pdt),
            "layers": [{"m": ssm.init_mamba_block(gen, cfg, self.pdt),
                        "ln": zeros(d)} for _ in range(cfg.n_layers)],
            "shared": [{"attn": L.init_attn(gen, cfg, self.pdt, 2 * d),
                        "mlp": L.init_mlp(gen, cfg, self.pdt),
                        "ln1": zeros(2 * d), "ln2": zeros(d)}
                       for _ in range(cfg.n_shared)],
            "apps": [{"linear": dense(d, d), "adapter_a": dense(d, r),
                      "adapter_b": dense(r, 2 * f)}
                     for _ in range(cfg.n_apps)],
            "final_norm": zeros(d),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense(d, cfg.vocab_padded)
        return params

    def _embed(self, params, tokens):
        return tp.embed(params["embed"], tokens, self.cdt)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return tp.logits(x, params["embed"], 0)
        return tp.logits(x, params["unembed"], 1)

    def _shared(self, params, j: int, x, e, attend):
        """Application ``j`` of the shared blocks to the residual ``x``
        [B,S,d] (``e`` the embeddings): the block's output through the
        application's ``linear``.  ``attend(p, hn)`` is the attention of
        the normed input ``hn``, out [B,S,d]."""
        cfg = self.cfg
        sp, ap = params["shared"][j % cfg.n_shared], params["apps"][j]
        with tracing.span("shared_block"):
            tracing.count("hybrid.shared_apps")
            h = torch.cat([x, e], dim=-1)
            a = attend(sp["attn"], L.rms_norm(h, sp["ln1"], cfg.norm_eps))
            h = L.rms_norm(a, sp["ln2"], cfg.norm_eps)
            m, cdt = sp["mlp"], h.dtype
            gu = (h @ ap["adapter_a"].to(cdt)) @ ap["adapter_b"].to(cdt)
            g = h @ m["wg"].to(cdt) + gu[..., :cfg.d_ff]
            u = h @ m["wi"].to(cdt) + gu[..., cfg.d_ff:]
            t = (F.gelu(g) * u) @ m["wo"].to(cdt)
            return t @ ap["linear"].to(cdt)

    def _layers(self, params, x, e, mamba, attend):
        """Every layer: the shared block where the layout has one, then
        the Mamba block ``mamba(i, lp, normed input)`` on the residual."""
        cfg = self.cfg
        app = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
        for i, lp in enumerate(params["layers"]):
            h = x
            if i in app:
                h = x + self._shared(params, app[i], x, e, attend)
            x = x + mamba(i, lp, L.rms_norm(h, lp["ln"], cfg.norm_eps))
        return x

    # ---------------- forward ----------------
    def forward(self, params, batch) -> torch.Tensor:
        """Full logits [B, S, V] on plain tensors (``ssd_chunked``, plain
        attention; small inputs only: tests)."""
        cfg = self.cfg
        params = unshard(params)
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._layers(
            params, x, x,
            lambda i, lp, h: ssm.mamba_forward(lp["m"], h, cfg, kernel=False),
            lambda p, hn: L.attn_forward(p, hn, cfg, positions, causal=True))
        return self._logits(params, x)

    def loss(self, params, batch, count=None):
        raise NotImplementedError(
            "training the published Zamba2 block is not implemented")

    # ---------------- serve ----------------
    def cache_spec(self, batch_size: int, max_len: int) -> Dict[str, Any]:
        """{name: (shape, dtype)} of the decode cache (``len`` an int)."""
        cfg = self.cfg
        kv = ((cfg.n_apps, batch_size, max_len, cfg.n_kv_heads,
               cfg.head_dim), self.cdt)
        return {
            "state": ((cfg.n_layers, batch_size, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_state), F32),
            "conv": ((cfg.n_layers, batch_size, cfg.ssm_conv - 1,
                      cfg.conv_dim), self.cdt),
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
        state and conv history, every application's K/V (padded to
        ``max_len`` positions)."""
        cfg = self.cfg
        _one_device(params, "prefill")
        x = self._embed(params, batch["tokens"])
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        states, convs, ks, vs = [], [], [], []

        def mamba(i, lp, h):
            y, st, conv = ssm.mamba_forward(lp["m"], h, cfg,
                                            return_cache=True)
            states.append(st)
            convs.append(conv)
            return y

        def attend(p, hn):
            o, k, v = L.flash_attn(p, hn, cfg, positions, causal=True)
            ks.append(k)
            vs.append(v)
            return o

        x = self._layers(params, x, x, mamba, attend)
        k_all, v_all = L.stack_kv(ks, vs, max_len)
        cache = {"state": torch.stack(states), "conv": torch.stack(convs),
                 "k": k_all, "v": v_all, "len": s}
        tracing.count("hybrid.prefills")
        tracing.count("hybrid.prefix_kv_bytes",
                      sum(cache[n].nbytes for n in ("k", "v")))
        tracing.count("hybrid.prefix_state_bytes",
                      sum(cache[n].nbytes for n in ("state", "conv")))
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache with ``len`` + 1).  The
        cache's buffers are updated in place (``ServeEngine.decode`` works
        on a copy), ``len`` too where it is a tensor; an int ``len`` (a
        prefill's cache) becomes a 0-d int64 tensor on the tokens' device
        in the cache returned.  Plain CUDA inputs with autograd off replay
        a CUDA graph of the step (``models.decode_graph``); the logits
        returned are then a copy of the graph's."""
        if not isinstance(cache["len"], torch.Tensor):
            cache = {**cache, "len": torch.full(
                (), cache["len"], dtype=torch.int64, device=tokens.device)}
        return self._graphs(self._decode_eager, params, cache, tokens)

    def _decode_eager(self, params, cache, tokens):
        """:meth:`decode_step`'s body, run eagerly (and captured): every
        use of the length ``cache["len"]`` (a 0-d tensor) is a device
        operation, and it advances in place."""
        cfg = self.cfg
        _one_device([params, cache, tokens], "decode step")
        x = self._embed(params, tokens)[:, None]
        n = cache["len"]
        state, conv = cache["state"], cache["conv"]
        app = iter(range(cfg.n_apps))

        def mamba(i, lp, h):
            y, state[i], conv[i] = ssm.mamba_step(lp["m"], h, cfg, state[i],
                                                  conv[i])
            return y

        def attend(p, hn):
            j = next(app)
            return L.attn_decode_forward(p, hn, cfg, cache["k"][j],
                                         cache["v"][j], n)

        x = self._layers(params, x, x, mamba, attend)
        n.add_(1)
        return self._logits(params, x)[:, 0], cache
