"""Attention-free Mamba2 LM (SSD) in PyTorch — the port of the JAX
package's ``repro.models.mamba_lm`` (the mamba2-370m family).

Parameters are ``{"embed", "layers": [{"m": block, "ln"}, ...],
"final_norm"[, "unembed"]}``; the cache keeps the JAX layout, ``state``
[L, B, H, P, N] float32 and ``conv`` [L, B, W-1, conv_dim].  The prefill
runs each block's scan through the SSD kernel (``models.ssm``), one
launch per layer, under ``torch.no_grad()``; ``forward`` and ``loss``
run the differentiable ``ssm.ssd_chunked`` instead, each block under
``transformer._remat``, and reach no kernel.

On a device mesh the parameters are DTensors: ``forward`` (tests)
gathers them at its entry (``distributed.sharding.unshard``) and runs the
blocks on plain tensors.  ``loss``, ``prefill`` and ``decode_step``
compute tensor-parallel over ``model`` on the parameters' shards
(``distributed.tp``; ``models.ssm.mamba_forward``), the prefill's
residual sequence-parallel under mesh rules (the train step's too). The prefill's cache
holds the rank's SSM heads and conv channels (``tp.lay_cache``), as
the reference's ``cache_shardings`` lays them out.

``decode_step`` and ``prefill`` on plain CUDA tensors with autograd off
are each one CUDA graph replay (``models.decode_graph``): the eager step
or prefill captured once per input layout (a prefill's layout at its
second call, while a graph of it may be kept); every other input runs it
eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import unshard
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.decode_graph import DecodeGraphs, PrefillGraphs
from repro_torch.models.transformer import _remat, lm_loss

F32 = torch.float32
Params = Dict[str, Any]


class Mamba2LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pdt = L.dtype_of(cfg.param_dtype)
        self.cdt = L.dtype_of(cfg.dtype)
        self._graphs = DecodeGraphs()
        self._prefill_graphs = PrefillGraphs()

    def init(self, gen: torch.Generator) -> Params:
        """Random weights drawn from ``gen`` on its device."""
        cfg = self.cfg
        params = {
            "embed": L.embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                  self.pdt),
            "layers": [{"m": ssm.init_mamba_block(gen, cfg, self.pdt),
                        "ln": L.zeros(gen, (cfg.d_model,), self.pdt)}
                       for _ in range(cfg.n_layers)],
            "final_norm": L.zeros(gen, (cfg.d_model,), self.pdt),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_padded), self.pdt)
        return params

    def _head(self, params):
        """(the loss head's weight, its vocabulary dim)."""
        if self.cfg.tie_embeddings:
            return params["embed"], 0
        return params["unembed"], 1

    def _embed(self, params, tokens):
        return tp.embed(params["embed"], tokens, self.cdt)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return tp.logits(x, params["embed"], 0)
        return tp.logits(x, params["unembed"], 1)

    def _body(self, params, batch, sp=None):
        """Every block (``ssd_chunked``, each under ``_remat``); with ``sp``
        the residual is sequence-parallel (the rank's block returned)."""
        cfg = self.cfg

        def block(h, lp):
            return h + ssm.mamba_forward(
                lp["m"], tp.gather_seq(L.seq_norm(h, lp["ln"], cfg.norm_eps,
                                                  sp), sp), cfg,
                kernel=False, sp=sp)

        block = _remat(block, cfg)
        x = tp.block(self._embed(params, batch["tokens"]), 1, sp)
        for lp in params["layers"]:
            x = block(x, lp)
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
        sp = tp.seq_axis(batch["tokens"].shape[1])
        head, vdim = self._head(params)
        return lm_loss(self._body(params, batch, sp), head,
                       params["final_norm"], batch, self.cfg.norm_eps, count,
                       vocab_dim=vdim, sp=sp)

    # ---------------- serve ----------------
    def cache_spec(self, batch_size: int, max_len: int = 0
                   ) -> Dict[str, Any]:
        """{name: (shape, dtype)} of the decode cache (O(1) in length)."""
        cfg = self.cfg
        conv_dim = cfg.conv_dim
        return {
            "state": ((cfg.n_layers, batch_size, cfg.ssm_heads,
                       cfg.ssm_headdim, cfg.ssm_state), F32),
            "conv": ((cfg.n_layers, batch_size, cfg.ssm_conv - 1, conv_dim),
                     self.cdt),
        }

    def init_cache(self, batch_size: int, max_len: int = 0,
                   device: DeviceLike = None) -> Params:
        """Zeroed SSD states and conv histories on ``device`` (``cuda``
        unless asked)."""
        dev = resolve_device(device)
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in self.cache_spec(batch_size).items()}

    def prefill(self, params, batch) -> Tuple[torch.Tensor, Params]:
        """Last-token logits [B, V] and the per-layer SSD states and conv
        histories, new tensors.  Plain CUDA inputs with autograd off replay
        a CUDA graph of the prefill (``models.decode_graph``), from their
        layout's second call on where a graph of it is kept, and return
        copies of its outputs."""
        return self._prefill_graphs(self._prefill_eager, params, batch)

    @torch.no_grad()
    def _prefill_eager(self, params, batch):
        """:meth:`prefill`'s body, run eagerly (and captured)."""
        cfg = self.cfg
        mesh = tp.mesh_of(params)
        params = tp.localize(params)
        x = self._embed(params, batch["tokens"])
        sp = tp.seq_axis(x.shape[1])
        x = tp.block(x, 1, sp)
        states, convs = [], []
        for lp in params["layers"]:
            y, st, conv = ssm.mamba_forward(
                lp["m"], tp.gather_seq(L.rms_norm(x, lp["ln"], cfg.norm_eps),
                                       sp), cfg, return_cache=True, sp=sp)
            x = x + y
            states.append(st)
            convs.append(conv)
        logits = self._logits(params, tp.last_token(x, sp))[:, 0]
        return logits, ssm_cache(cfg, mesh, states, convs)

    def decode_step(self, params, cache, tokens) -> Tuple[torch.Tensor,
                                                          Params]:
        """tokens: [B] -> (logits [B, V], cache).  The cache's buffers are
        updated in place (``ServeEngine.decode`` works on a copy).  A cache
        and tokens laid out by ``launch.specs`` decode each rank's rows
        (``layers.decode_inputs``).  Plain CUDA inputs with autograd off
        replay a CUDA graph of the step (``models.decode_graph``); the
        logits returned are then a copy of the graph's."""
        return self._graphs(self._decode_eager, params, cache, tokens)

    def _decode_eager(self, params, cache, tokens):
        """:meth:`decode_step`'s body, run eagerly (and captured)."""
        cfg = self.cfg
        params = tp.localize(params)
        loc, tokens, _, wrap = L.decode_inputs(cache, tokens)
        x = self._embed(params, tokens)[:, None]
        for i, lp in enumerate(params["layers"]):
            y, st, conv = ssm.mamba_step(
                lp["m"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                loc["state"][i], loc["conv"][i])
            x = x + y
            loc["state"][i] = st
            loc["conv"][i] = conv
        return wrap(self._logits(params, x)[:, 0]), cache


def ssm_cache(cfg: ModelConfig, mesh, states, convs) -> Params:
    """A prefill's per-layer SSD states and conv histories stacked, each
    laid out on ``mesh`` as ``launch.specs.cache_shardings`` lays it out
    (``distributed.tp.lay_cache``: its heads and channels on the model
    axis, the batch on the data axes)."""
    return {"state": tp.lay_cache(torch.stack(states), mesh, 2,
                                  cfg.ssm_heads),
            "conv": tp.lay_cache(torch.stack(convs), mesh, 3,
                                 cfg.conv_dim)}
