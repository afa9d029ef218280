"""Build and load the flash-attention CUDA kernels through the shared
nvcc + ctypes helper (``repro_torch.kernels._build``), at first use, into
``build/repro_torch_kernels/``: ``csrc/flash.cu`` (float32, CUDA cores)
and ``csrc/flash_wgmma.cu`` (bf16, wgmma and TMA)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import BASE_FLAGS, KernelLibrary, nvcc_path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash.cu"
SOURCE_BF16 = CSRC / "flash_wgmma.cu"
NVCC_FLAGS = BASE_FLAGS


def _declarer(name: str):
    def declare(lib: ctypes.CDLL) -> None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, vp]
        fn.restype = ci
    return declare


KERNEL = KernelLibrary(SOURCE, NVCC_FLAGS,
                       _declarer("flash_attention_fwd_f32"))
KERNEL_BF16 = KernelLibrary(SOURCE_BF16, NVCC_FLAGS,
                            _declarer("flash_attention_fwd_bf16"))
KERNELS = (KERNEL, KERNEL_BF16)

__all__ = ["SOURCE", "SOURCE_BF16", "NVCC_FLAGS", "KERNEL", "KERNEL_BF16",
           "KERNELS", "nvcc_path"]
