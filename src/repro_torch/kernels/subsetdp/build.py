"""Build and load the subset-DP CUDA kernel (``csrc/subsetdp.cu``).

nvcc compiles the source into a shared library with a plain C interface,
loaded with ctypes.  The build runs at first use — never at import, so
the module imports on hosts without a CUDA toolkit — and lands in
``build/repro_torch_kernels/`` at the repository root, named by the
source's content hash: an edited source rebuilds, an unchanged one loads
the existing library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsetdp.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIB = None


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the subset-DP "
        "kernel is compiled at first use on a host with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsubsetdp_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel unless a library for this source exists; returns
    its path.  The write is atomic (temp file + rename)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every
    function's argument and return types declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.subsetdp_prod.argtypes = [vp, vp, ll, vp, ll, ci, vp]
        lib.subsetdp_prod.restype = ci
        lib.subsetdp_argmin.argtypes = [vp, vp, vp, ll, vp, vp, ll, ci, vp]
        lib.subsetdp_argmin.restype = ci
        _LIB = lib
    return _LIB
