"""Batched Bloom-filter probe: CUDA kernel (``csrc/bloom.cu``), plain torch
version (``ref``), and the dispatching wrappers (``ops``)."""
from repro_torch.kernels.bloom.ops import (
    LAUNCHES,
    bloom_probe,
    build_indicator,
    reset_launches,
)
from repro_torch.kernels.bloom.ref import bloom_probe_ref, build_indicator_ref

__all__ = ["LAUNCHES", "bloom_probe", "build_indicator", "reset_launches",
           "bloom_probe_ref", "build_indicator_ref"]
