"""Guards on the port's package boundary and device rules.

  * importing every ``repro_torch`` module pulls in neither JAX nor any
    module of the JAX package ``repro``;
  * entry points default to ``cuda`` and raise without a GPU instead of
    carrying on on the CPU; CPU tensors take the plain kernel path
    without counting a launch;
  * the kernel module imports (and only fails when asked to build) on a
    host without the CUDA toolkit.
"""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.cachesim import SimConfig, Simulator, run_policies
from repro_torch.kernels.subsetdp import ops

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_reference():
    mods = _all_modules()
    assert "repro_torch.kernels.subsetdp.ops" in mods
    assert "repro_torch.cachesim.engine" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_entry_points_raise_without_gpu(monkeypatch):
    """Without a visible GPU, the default device is an error — never a
    silent CPU run; ``device="cpu"`` is the explicit way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(cache_size=100, update_interval=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_policies(np.arange(10), cfg, ("fna",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.subset_argmin([1.0, 2.0], np.full((3, 2), 0.5), 10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.subset_dp([1.0, 2.0], np.full((3, 2), 0.5), 10.0)
    assert Simulator(cfg, device="cpu").device == torch.device("cpu")


def test_cpu_tensors_take_plain_path_without_counting():
    before = dict(ops.LAUNCHES)
    rhos = torch.full((4, 3), 0.5, dtype=torch.float64)
    best = ops.subset_argmin([1.0, 2.0, 3.0], rhos, 20.0)
    assert best.device.type == "cpu" and best.dtype == torch.int64
    ops.subset_prod(rhos, 20.0)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.subset_argmin([1.0, 2.0, 3.0], rhos, 20.0, device="cuda")


def test_kernel_module_imports_without_nvcc(tmp_path):
    """No nvcc anywhere: the kernel modules import fine, and only an
    explicit build request fails, naming the missing compiler."""
    code = (
        "import repro_torch.kernels.subsetdp.ops as ops\n"
        "import repro_torch.kernels.subsetdp.build as build\n"
        "import repro_torch.cachesim.engine\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('NO_NVCC', 'nvcc not found' in str(e))\n")
    proc = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "NO_NVCC True" in proc.stdout, proc.stdout
