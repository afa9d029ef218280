"""Build and load the subset-DP CUDA kernel (``csrc/subsetdp.cu``) through
the shared nvcc + ctypes helper (``repro_torch.kernels._build``), at first
use, into ``build/repro_torch_kernels/``.  ``--fmad=false`` keeps every
multiply and add separately rounded (the bit-exact contract)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import BASE_FLAGS, KernelLibrary, nvcc_path

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsetdp.cu"
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.subsetdp_prod.argtypes = [vp, vp, ll, vp, ll, ci, vp]
    lib.subsetdp_prod.restype = ci
    lib.subsetdp_argmin.argtypes = [vp, vp, vp, ll, vp, vp, ll, ci, vp]
    lib.subsetdp_argmin.restype = ci


KERNEL = KernelLibrary(SOURCE, NVCC_FLAGS, _declare)
library_path = KERNEL.library_path
build = KERNEL.build
load = KERNEL.load

__all__ = ["SOURCE", "NVCC_FLAGS", "KERNEL", "build", "library_path", "load",
           "nvcc_path"]
