"""Mamba2 SSD chunked scan: CUDA kernel (``csrc/ssd.cu``), plain torch
version (``ref``), and the dispatching wrapper (``ops``)."""
from repro_torch.kernels.ssd.ops import (LAUNCHES, MMA_LAUNCHES,
                                        reset_launches, ssd_scan, ssd_work)
from repro_torch.kernels.ssd.ref import ssd_scan_ref

__all__ = ["LAUNCHES", "MMA_LAUNCHES", "reset_launches", "ssd_scan",
           "ssd_scan_ref", "ssd_work"]
