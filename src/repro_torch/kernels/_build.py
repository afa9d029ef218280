"""Build and load a CUDA kernel source with nvcc (shared by every kernel).

nvcc compiles one ``csrc/*.cu`` file into a shared library with a plain C
interface, loaded with ctypes.  The build runs at first use — never at
import, so kernel modules import on hosts without a CUDA toolkit — and
lands in ``build/repro_torch_kernels/`` at the repository root, named by
the source's content hash and the flags: an edited source rebuilds, an
unchanged one loads the existing library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are compiled at first use on a host with the CUDA toolkit")


class KernelLibrary:
    """One CUDA source, its nvcc flags, and the ctypes signatures that
    ``declare(lib)`` sets on the loaded library."""

    def __init__(self, source: Path, flags: Sequence[str],
                 declare: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.flags = tuple(flags)
        self._declare = declare
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() +
                                " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile unless a library for this source exists; returns its
        path.  The write is atomic (temp file + rename), so concurrent
        builds of one source leave one whole library."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *self.flags, "-o", tmp, str(self.source)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr, end="")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first call), its functions'
        argument and return types declared."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._declare(lib)
            self._lib = lib
        return self._lib
