"""Flash-attention forward (GQA, causal or not): CUDA kernel
(``csrc/flash.cu``), plain torch version (``ref``), and the dispatching
wrapper (``ops``)."""
from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    flash_attention,
    flash_work,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["LAUNCHES", "flash_attention", "flash_work", "reset_launches",
           "flash_attention_ref"]
