"""Guards on the port's package boundary and device rules.

  * importing every ``repro_torch`` module pulls in neither JAX nor any
    module of the JAX package ``repro``;
  * entry points default to ``cuda`` and raise without a GPU instead of
    carrying on on the CPU; CPU tensors take the plain kernel path
    without counting a launch;
  * the kernel modules import (and only fail when asked to build) on a
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
from repro_torch.kernels import bloom
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
    for name in ("repro_torch.kernels.bloom.ops",
                 "repro_torch.kernels.bloom.build", "repro_torch.kernels._build",
                 "repro_torch.serving.prefix_cache",
                 "repro_torch.serving.replay", "repro_torch.launch.serve",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.build",
                 "repro_torch.kernels.ssd.ops", "repro_torch.kernels.ssd.build",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.smollm_135m",
                 "repro_torch.configs.mamba2_370m",
                 "repro_torch.models.layers", "repro_torch.models.transformer",
                 "repro_torch.models.ssm", "repro_torch.models.mamba_lm",
                 "repro_torch.models.registry", "repro_torch.models.convert",
                 "repro_torch.serving.engine",
                 "repro_torch.cachesim.sweep", "repro_torch.cachesim.scenarios",
                 "repro_torch.cachesim.store",
                 "repro_torch.cachesim.tracefiles",
                 "repro_torch.cachesim.topology",
                 "repro_torch.tools.store_tool"):
        assert name in mods, name
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


def test_grid_entry_points_raise_without_gpu(monkeypatch):
    """The grid layer's entry points run on the card by default: without a
    GPU they raise before any sweep; ``device="cpu"`` runs them."""
    from repro_torch.cachesim import (TopoConfig, get_scenario, run_grid,
                                      run_scenario, run_sweep,
                                      run_topo_grid, run_topology,
                                      scenario_grid)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = np.arange(50) % 7
    cfg = SimConfig(cache_size=100, update_interval=20)
    topo = TopoConfig(base=cfg, kind="path", depth=2)
    sc = get_scenario("fig4_gradle")
    calls = {
        "run_grid": lambda **kw: run_grid({"t": trace}, cfg,
                                          "update_interval", (20,), **kw),
        "run_sweep": lambda **kw: run_sweep({"t": trace}, cfg, (20,), **kw),
        "run_scenario": lambda **kw: run_scenario(sc, n_requests=50, **kw),
        "scenario_grid": lambda **kw: scenario_grid(sc, n_requests=50, **kw),
        "run_topology": lambda **kw: run_topology(trace, topo, ("fna",),
                                                  **kw),
        "run_topo_grid": lambda **kw: run_topo_grid(
            {"t": trace}, topo, "depth", (1, 2), ("fna",), **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu"), name


def test_grid_mesh_other_than_none_raises():
    from repro_torch.cachesim import run_cells, run_grid
    trace = np.arange(50) % 7
    cfg = SimConfig(cache_size=100, update_interval=20)
    for call in (lambda: run_grid({"t": trace}, cfg, "update_interval",
                                  (20,), device="cpu", mesh="sweep"),
                 lambda: run_cells(trace, [cfg], ("fna",), device="cpu",
                                   mesh="sweep")):
        with pytest.raises(NotImplementedError, match="mesh"):
            call()


def test_bloom_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(10, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bloom.build_indicator(keys, 64, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bloom.bloom_probe(np.zeros((2, 8), np.uint8), keys, k=3)
    bits = bloom.build_indicator(keys, 64, 3, device="cpu")
    assert bits.device.type == "cpu"
    assert bool(bloom.bloom_probe(bits[None], keys, k=3).all())


def test_lm_entry_points_raise_without_gpu(monkeypatch):
    """The serving engine, the weight draw and both LM kernel wrappers run
    on the card by default; their inputs' device decides for a tensor."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--requests", "1"])
    assert ServeEngine(cfg, device="cpu").device == torch.device("cpu")
    q = np.zeros((1, 4, 2, 16), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fa.flash_attention(q, q, q)
    ssd_args = (q, np.full((1, 4, 2), 0.1, np.float32),
                np.full(2, -1.0, np.float32), np.zeros((1, 4, 8), np.float32),
                np.zeros((1, 4, 8), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssd.ssd_scan(*ssd_args, chunk=4)
    assert fa.flash_attention(q, q, q, device="cpu").device.type == "cpu"
    y, st = ssd.ssd_scan(*ssd_args, chunk=4, device="cpu")
    assert y.shape == (1, 4, 2, 16) and st.shape == (1, 2, 16, 8)
    meta = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd.ssd_scan(meta, torch.empty((1, 4, 2), device="meta"),
                     torch.empty(2, device="meta"),
                     torch.empty((1, 4, 8), device="meta"),
                     torch.empty((1, 4, 8), device="meta"), chunk=4)


def _stack_layers(tree):
    """The port's per-layer parameter list as the JAX layout's stacked
    NumPy leaves (leading ``L`` dimension)."""
    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: stack([x[k] for x in leaves]) for k in leaves[0]}
        return np.stack([x.numpy() for x in leaves])
    out = {k: v.numpy() for k, v in tree.items() if k != "layers"}
    out["layers"] = stack(tree["layers"])
    return out


@pytest.mark.parametrize("helper", ["params_from_jax", "transformer_cache",
                                    "mamba_cache", "concrete_batch"])
def test_model_helpers_default_to_cuda(monkeypatch, helper):
    """The weight converter, both decode caches and the concrete batch run
    on the card unless ``device="cpu"`` is passed, and raise without a
    GPU (``resolve_device``'s message)."""
    from repro_torch.configs import get_config
    from repro_torch.models import (get_model, init_params,
                                    make_concrete_batch, params_from_jax)
    arch = "mamba2-370m" if helper == "mamba_cache" else "smollm-135m"
    cfg = get_config(arch).reduced()
    model = get_model(cfg)
    call = {
        "params_from_jax": lambda **kw: params_from_jax(
            cfg, _stack_layers(init_params(cfg, device="cpu")), **kw),
        "transformer_cache": lambda **kw: model.init_cache(2, 8, **kw),
        "mamba_cache": lambda **kw: model.init_cache(2, **kw),
        "concrete_batch": lambda **kw: make_concrete_batch(
            cfg, 2, 5, torch.Generator().manual_seed(0), **kw),
    }[helper]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    leaves = [out["embed"]] if helper == "params_from_jax" else \
        [v for v in out.values() if isinstance(v, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_other_families_raise_not_implemented():
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    for arch in ("qwen3-moe-30b-a3b", "internvl2-1b", "seamless-m4t-medium",
                 "zamba2-7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            get_model(get_config(arch).reduced())


def test_cpu_tensors_take_plain_path_without_counting():
    before = dict(ops.LAUNCHES)
    rhos = torch.full((4, 3), 0.5, dtype=torch.float64)
    best = ops.subset_argmin([1.0, 2.0, 3.0], rhos, 20.0)
    assert best.device.type == "cpu" and best.dtype == torch.int64
    ops.subset_prod(rhos, 20.0)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.subset_argmin([1.0, 2.0, 3.0], rhos, 20.0, device="cuda")
    before = dict(bloom.LAUNCHES)
    bits = torch.zeros((3, 8), dtype=torch.uint8)
    bloom.bloom_probe(bits, torch.arange(4), k=2)
    assert bloom.LAUNCHES == before
    with pytest.raises(ValueError):
        bloom.bloom_probe(bits, torch.arange(4), k=2, device="cuda")


def test_kernel_module_imports_without_nvcc(tmp_path):
    """No nvcc anywhere: the kernel modules import fine, and only an
    explicit build request fails, naming the missing compiler."""
    code = (
        "import repro_torch.kernels.subsetdp.ops as ops\n"
        "import repro_torch.kernels.subsetdp.build as build\n"
        "import repro_torch.kernels.bloom.ops as bloom_ops\n"
        "import repro_torch.kernels.bloom.build as bloom_build\n"
        "import repro_torch.cachesim.engine\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attention.build as fa_build\n"
        "import repro_torch.kernels.ssd.build as ssd_build\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.ssd.ops, repro_torch.models\n"
        "for b in (build, bloom_build, fa_build, ssd_build):\n"
        "    try:\n"
        "        b.nvcc_path()\n"
        "    except RuntimeError as e:\n"
        "        print('NO_NVCC', b.SOURCE.name, 'nvcc not found' in str(e))\n")
    proc = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert "NO_NVCC subsetdp.cu True" in proc.stdout, proc.stdout
    assert "NO_NVCC bloom.cu True" in proc.stdout, proc.stdout
    assert "NO_NVCC flash.cu True" in proc.stdout, proc.stdout
    assert "NO_NVCC ssd.cu True" in proc.stdout, proc.stdout
