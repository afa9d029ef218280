"""Model configurations of the port: a copy of the JAX package's
``repro.configs.base`` (plain dataclasses, no JAX), kept here because the
port imports nothing of that package.

Every architecture has its own module in ``repro_torch.configs``
exporting a ``CONFIG: ModelConfig``.  Input shapes (the ``train_4k`` /
``prefill_32k`` / ``decode_32k`` / ``long_500k`` cells) are described by
:class:`ShapeConfig` and the applicability rules live in
:func:`repro_torch.configs.registry.cells`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters + runtime knobs.

    ``family`` selects the model implementation:
      * ``dense``   – decoder-only transformer (GQA) [transformer.py]
      * ``moe``     – decoder-only transformer with MoE FFN [transformer.py]
      * ``vlm``     – decoder-only transformer consuming a precomputed
                      patch-embedding prefix (modality frontend is a STUB)
      * ``encdec``  – encoder/decoder transformer; encoder consumes
                      precomputed audio-frame embeddings (STUB frontend)
      * ``ssm``     – attention-free Mamba2 (SSD) stack
      * ``hybrid``  – Mamba2 backbone with shared attention blocks (Zamba2)
    """

    name: str
    family: str  # dense | moe | vlm | encdec | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # Derived unless overridden: head_dim = d_model // n_heads.
    head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    # d_ff above is the *per-expert* hidden dim for MoE families.
    moe_mode: str = "dense"  # dense | dispatch  (see models/layers.py)
    capacity_factor: float = 1.25
    expert_pad: int = 1      # pad expert count to a multiple (16 for TP meshes)
    moe_groups: int = 16     # dispatch groups per sequence (model-axis aligned)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1      # B/C groups; head h reads group h // (H / groups)

    # --- Hybrid (Zamba2) ---
    shared_every: int = 6   # apply a shared attention block every k mamba blocks
    n_shared: int = 2       # number of alternating shared blocks
    # The published block (Zyphra/Zamba2-7B-Instruct, arXiv:2411.15242;
    # ``models.zamba2_published``) where ``hybrid_layer_ids`` is given: a
    # shared block on [x, embeddings] before each listed layer's Mamba
    # block, its output through the application's own ``linear`` into that
    # block's input.  The defaults keep the JAX
    # package's narrowed block (after every ``shared_every`` Mamba blocks).
    hybrid_layer_ids: Tuple[int, ...] = ()
    adapter_rank: int = 0          # rank of each application's gate/up adapter
    attn_scale: float = 0.0        # softmax scale; 0 gives head_dim ** -0.5

    # --- Modality stubs ---
    n_patches: int = 0      # vlm: number of precomputed patch embeddings
    enc_layers: int = 0     # encdec: encoder depth (n_layers is decoder depth)

    # --- Runtime knobs ---
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master weights
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_mode: str = "chunked"     # chunked | naive | pallas
    attn_chunk: int = 1024         # KV chunk for the chunked (flash-style) path
    # int8 KV cache (decoder-only families): per-(token, head) absmax scales;
    # halves decode HBM traffic vs bf16 (EXPERIMENTS.md §Perf cell 3, iter C3)
    kv_quant: bool = False
    remat: str = "full"            # full | none | dots
    # Sequence-parallel residual stream (activations sharded on "model"
    # axis between blocks).  See distributed/sharding.py.
    seq_parallel: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        # a configuration file gives the ids as a JSON list
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    # ---- derived quantities -------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (TP-shardable, MXU-aligned).
        Padded entries are ordinary unused classes (standard practice)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_experts_padded(self) -> int:
        if not self.n_experts:
            return 0
        return ((self.n_experts + self.expert_pad - 1) // self.expert_pad) * self.expert_pad

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        """Channels of the Mamba2 conv: x and every group's B and C."""
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def softmax_scale(self) -> float:
        return self.attn_scale or self.head_dim ** -0.5

    @property
    def n_apps(self) -> int:
        """Applications of the hybrid's shared blocks."""
        if self.hybrid_layer_ids:
            return len(self.hybrid_layer_ids)
        return self.n_layers // self.shared_every

    def param_count(self) -> int:
        """Analytic parameter count (matches models/*.init_params)."""
        d, v = self.d_model, self.vocab_padded
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # unembedding
        attn = d * (self.n_heads * self.head_dim) + 2 * d * (self.n_kv_heads * self.head_dim) \
            + (self.n_heads * self.head_dim) * d
        dense_ffn = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + dense_ffn + 2 * d)
            if self.family == "vlm":
                n += d * d  # patch_proj
        elif self.family == "moe":
            ep = self.n_experts_padded
            moe_ffn = ep * 3 * d * self.d_ff + d * ep  # experts + router
            n += self.n_layers * (attn + moe_ffn + 2 * d)
        elif self.family == "encdec":
            cross = attn
            n += d * d + d  # frame_proj + enc_norm
            n += self.enc_layers * (attn + dense_ffn + 2 * d)
            n += self.n_layers * (attn + cross + dense_ffn + 3 * d)
        elif self.family == "ssm":
            n += self.n_layers * (self._mamba_block_params() + d)
        elif self.family == "hybrid" and self.hybrid_layer_ids:
            din = 2 * d     # the shared block reads [x, embeddings]
            hd = self.head_dim
            attn = din * (self.n_heads + 2 * self.n_kv_heads) * hd + \
                self.n_heads * hd * d
            n += self.n_layers * (self._mamba_block_params() + d)
            n += self.n_shared * (attn + dense_ffn + din + d)
            n += self.n_apps * (d * d + self.adapter_rank * (d + 2 * self.d_ff))
        elif self.family == "hybrid":
            n += self.n_layers * (self._mamba_block_params() + d)
            n += self.n_shared * (attn + dense_ffn + 2 * d)
        n += d  # final norm
        return n

    def _mamba_block_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        # in_proj -> [z, x, B, C, dt] ; conv over (x, B, C); out_proj
        ng = self.ssm_groups
        in_proj = d * (2 * di + 2 * ng * ns + nh)
        conv = (self.ssm_conv + 1) * (di + 2 * ng * ns)  # conv_w + conv_b
        out_proj = di * d
        misc = 3 * nh  # A_log, D, dt_bias
        return in_proj + conv + out_proj + misc + di  # + gate norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: topk experts only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.topk) * 3 * self.d_model * self.d_ff
        return full - inactive

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=96 if self.family != "moe" else 32,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            expert_pad=1,
            moe_groups=4,
            moe_mode="dense" if self.family == "moe" else self.moe_mode,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=16,
            shared_every=2,
            n_shared=min(self.n_shared, 2),
            n_patches=16 if self.n_patches else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            dtype="float32",
            param_dtype="float32",
            remat="none",
            attn_chunk=32,
        )
        if self.hybrid_layer_ids:     # every mechanism, at a tiny size
            kw.update(n_layers=4, hybrid_layer_ids=(1, 3),
                      adapter_rank=min(self.adapter_rank, 8),
                      attn_scale=self.attn_scale * math.sqrt(
                          self.head_dim / 16))
        kw.update(over)
        return dataclasses.replace(self, **kw)


#: the port's fields beyond the JAX package's ``ModelConfig`` (B/C groups and
#: the published Zamba2 block), at the values that keep its models
PORT_DEFAULTS = {"ssm_groups": 1, "hybrid_layer_ids": (),
                 "adapter_rank": 0, "attn_scale": 0.0}


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
