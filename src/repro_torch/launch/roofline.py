"""Roofline terms of a traced step on the NVIDIA H100 — the counterpart
of the JAX package's ``repro.launch.hlo_analysis``.

The card's constants (NVIDIA H100 SXM5 80GB HBM3 data sheet, at its
700 W power limit; a card set below 700 W runs slower under load):

  * ``PEAK_FLOPS``  — 989e12 dense bf16 FLOP/s on the tensor cores;
  * ``HBM_BW``      — 3.35e12 bytes/s of HBM3;
  * ``NVLINK_BW``   — 450e9 bytes/s per direction per GPU over NVLink 4
    (18 links), within a node of ``NODE_GPUS`` = 8;
  * ``NETWORK_BW``  — 400 Gb/s = 50 GB/s per GPU between nodes (one NDR
    InfiniBand port per GPU).

Which mesh axes stay within a node: ranks are numbered along the mesh's
last axis first, so a node's 8 GPUs are 8 consecutive ranks of the
16-wide ``"model"`` axis, and that axis spans two nodes; ``"data"`` and
``"pod"`` cross nodes.  Every collective of the production meshes
therefore crosses the network (a model-axis ring has two inter-node
hops), and the collective term uses ``NETWORK_BW`` — the rate of the
slowest link each collective's bytes pass.

``parse_collectives`` (HLO text) has no counterpart: the cost trace
(``launch.cost``) counts collective bytes as the c10d operations pass.
``model_flops`` and ``essential_bytes`` are the reference's, copied
verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

#: NVIDIA H100 SXM5 80GB HBM3 at 700 W, data sheet: dense bf16 FLOP/s
PEAK_FLOPS = 989e12
#: its HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink 4 bytes/s per direction per GPU, within a node
NVLINK_BW = 450e9
#: NDR InfiniBand bytes/s per GPU, between nodes: one 400 Gb/s port
NETWORK_BW = 400e9 / 8
#: GPUs a node: consecutive ranks along the mesh's last axis
NODE_GPUS = 8
CARD = "NVIDIA H100 80GB HBM3, 700 W, data-sheet constants"


def axes_within_node(mesh_shape: Dict[str, int]) -> tuple:
    """The mesh axes whose every group lies within one node of
    ``NODE_GPUS`` consecutive ranks (ranks run along the last axis
    first)."""
    names = list(mesh_shape)
    inner = 1
    out = []
    for name in reversed(names):
        inner *= mesh_shape[name]
        if inner > NODE_GPUS:
            break
        out.append(name)
    return tuple(reversed(out))


@dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops_total: float = 0.0  # 6*N*D (train) / 2*N*D (inference)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        # every production-mesh collective crosses nodes (the 16-wide
        # model axis spans two), so its bytes pass the network's link
        return self.collective_bytes_per_device / NETWORK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def step_time(self) -> float:
        """Roofline-model step time: max of the three terms (perfect
        overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline-model step time."""
        if self.step_time == 0:
            return 0.0
        return (self.model_flops_total / self.chips / self.step_time) \
            / PEAK_FLOPS

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_step_time_s": self.step_time,
            "mfu_at_roofline": self.mfu,
        }


def essential_bytes(cfg, shape, chips: int, model_shards: int = 16) -> float:
    """Analytic LOWER BOUND on per-device HBM traffic per step.

    Counts only unavoidable traffic: parameter/optimizer IO, KV/state cache
    read+write (decode), and one residual-stream read+write per layer.
    The HLO-derived number sits above this; the gap is softmax/score
    materialisation, dtype-convert and layout-copy artifacts (CPU backend),
    and remat recompute traffic.
    """
    p = cfg.param_count()
    p_dev = p / model_shards
    d = cfg.d_model
    layers = cfg.n_layers + (cfg.enc_layers or 0)
    if shape.kind == "train":
        # fwd read (bf16 cast) + grad write + adam m/v read+write + param rw (fp32)
        params_io = p_dev * (2 + 4 + 4 * 4 + 4 * 2)
        tokens_dev = shape.global_batch * shape.seq_len / (chips / model_shards)
        act_io = layers * tokens_dev * d * 2 * 2 * 3  # resid in/out, fwd+bwd+remat
        return params_io + act_io
    if shape.kind == "prefill":
        params_io = p_dev * 2
        tokens_dev = shape.global_batch * shape.seq_len / (chips / model_shards)
        act_io = layers * tokens_dev * d * 2 * 2
        kv_write = 2 * layers * tokens_dev * cfg.n_kv_heads * cfg.head_dim * 2
        return params_io + act_io + kv_write
    # decode: params + full cache read + new-token write
    params_io = p_dev * 2
    if cfg.family in ("ssm",):
        cache = cfg.n_layers * shape.global_batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    elif cfg.family == "hybrid":
        napps = cfg.n_layers // cfg.shared_every
        cache = (cfg.n_layers * shape.global_batch * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
                 + napps * shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
    else:
        cache = 2 * layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.head_dim * 2
    # cache is sharded across all chips: read once per step; the one-token
    # write is negligible next to the read.
    return params_io + cache / chips


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the cell: 6*N*D train, 2*N*D prefill,
    2*N*B decode (+ attention KV-read term for decode handled in memory)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
