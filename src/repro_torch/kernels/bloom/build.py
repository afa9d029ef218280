"""Build and load the Bloom-probe CUDA kernel (``csrc/bloom.cu``) through
the shared nvcc + ctypes helper (``repro_torch.kernels._build``), at first
use, into ``build/repro_torch_kernels/``."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import BASE_FLAGS, KernelLibrary, nvcc_path

SOURCE = Path(__file__).resolve().parent / "csrc" / "bloom.cu"
NVCC_FLAGS = BASE_FLAGS


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bloom_probe.argtypes = [vp, ci, ll, vp, vp, ci, ll, ci, vp, vp]
    lib.bloom_probe.restype = ci


KERNEL = KernelLibrary(SOURCE, NVCC_FLAGS, _declare)
library_path = KERNEL.library_path
build = KERNEL.build
load = KERNEL.load

__all__ = ["SOURCE", "NVCC_FLAGS", "KERNEL", "build", "library_path", "load",
           "nvcc_path"]
