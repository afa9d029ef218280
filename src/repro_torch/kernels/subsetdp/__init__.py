"""Eq. (10) subset-DP: CUDA kernel (``csrc/subsetdp.cu``), plain torch
version (``ref``), and the dispatching wrappers (``ops``)."""
from repro_torch.kernels.subsetdp.ops import (
    LAUNCHES,
    reset_launches,
    subset_argmin,
    subset_dp,
    subset_prod,
)

__all__ = ["LAUNCHES", "reset_launches", "subset_argmin", "subset_dp",
           "subset_prod"]
