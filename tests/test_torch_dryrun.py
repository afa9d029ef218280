"""The port's dry run (``repro_torch.launch.{specs,cost,roofline,dryrun}``,
``models.input_specs``, meta-device parameters, the kernels' meta paths)
and its examples, held against the JAX package.

  * ``cells()``: the reference's 32 cells in its order;
  * ``input_specs`` of every cell: the reference's shapes, its types with
    token ids int32 -> int64 (the port's one type mapping), a decode
    cache's ``len`` an int where the reference has an int32 scalar;
  * meta parameters of the ten published configs: every leaf's shape
    equals ``jax.eval_shape(model.init)``'s leaf through ``tree.jax_leaf``
    (a per-block leaf without the stacked axis), the total
    ``cfg.param_count()``;
  * the four ``specs.py`` shardings of every cell on both production
    meshes equal the reference's ``PartitionSpec``s, computed in one
    subprocess on 512 forced host devices with ``jax.make_mesh`` wrapped
    to Auto axis types (ROADMAP C-ref-3);
  * ``model_flops`` / ``essential_bytes`` equal the reference's for every
    cell at 256 and 512 chips;
  * the cost trace on ``hlo_cost``'s synthetic loop (12 products [8, 16]
    @ [16, 16] and an all-reduce in a fake world);
  * the traced dot FLOPs of every family's reduced config against
    ``repro.launch.hlo_cost.analyze`` of the JAX step compiled on one CPU
    device: decode equal; prefill equal once the work the kernels skip is
    added back (the flash kernel counts only the (query, key) pairs its
    causal mask keeps and the SSD kernel the kept pairs of each chunk,
    where the JAX prefill's plain attention and ``ssd_chunked`` multiply
    the whole score and chunk matrices before masking); train within
    ``TRAIN_REL`` (two contractions XLA and torch order differently: the
    MoE dense combine ``etd,te->td`` and the SSD's four-operand
    chunk-state einsum ``bclh,bclh,bcln,bclhp->bchpn``);
  * ``run_cell`` of one cell per family and kind on the meta device
    writes a JSON with the reference record's keys;
  * the command line writes its JSON without importing JAX;
  * no TPU constant (197e12, 819e9, 50e9) in ``repro_torch``;
  * the kernels' meta paths: shapes and types, no launch, the work
    reported to the trace;
  * each ``examples/torch_*.py`` at a small size on the CPU, the
    quickstart's costs equal to the reference's ``run_policies``.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, cells, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as S
from repro_torch.launch.cost import CostTrace
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import init_params, input_specs
from repro_torch.optim import OptConfig, init_train_state
from repro_torch.tree import jax_leaf, tree_paths

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
CELLS = list(cells())
MESH_KINDS = ("single", "multi")
#: reference dtype name -> the port's
DTYPES = {"int32": torch.int64, "bfloat16": torch.bfloat16,
          "float32": torch.float32, "int8": torch.int8}
#: one reduced config per family
FAMILIES = {"dense": "smollm-135m", "moe": "granite-moe-3b-a800m",
            "vlm": "internvl2-1b", "encdec": "seamless-m4t-medium",
            "ssm": "mamba2-370m", "hybrid": "zamba2-7b"}
KINDS = ("train", "prefill", "decode")
#: traced train FLOPs vs the JAX step's: relative tolerance (see module
#: docstring: two contractions ordered differently)
TRAIN_REL = 5e-3
#: the reduced cells' shape: 64 positions (16 of them vlm patches), 2 rows
SMALL_SEQ, SMALL_BATCH = 64, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


# ---------------------------------------------------------------------------
# cells, inputs, parameters
# ---------------------------------------------------------------------------

def test_cells_equal_reference():
    from repro.configs import cells as ref_cells
    assert CELLS == list(ref_cells())
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(arch, shape_name):
    import jax
    from repro.configs import get_config as ref_config
    from repro.configs import get_shape as ref_shape
    from repro.models import input_specs as ref_specs
    want = ref_specs(ref_config(arch), ref_shape(shape_name))
    got = input_specs(get_config(arch), get_shape(shape_name))
    assert set(got) == set(want)
    for part in want:
        w, g = want[part], got[part]
        if not isinstance(w, dict):
            w, g = {"": w}, {"": g}
        assert set(g) == set(w), (part, sorted(g), sorted(w))
        for name, sds in w.items():
            assert isinstance(sds, jax.ShapeDtypeStruct)
            if name == "len":       # an int32 scalar there, an int here
                assert sds.shape == () and isinstance(g[name], int)
                assert g[name] == get_shape(shape_name).seq_len - 1
                continue
            t = g[name]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(sds.shape), (part, name)
            assert t.dtype == DTYPES[str(sds.dtype)], (part, name, t.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_eval_shape(arch):
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import get_model as ref_model
    cfg = get_config(arch)
    model = ref_model(ref_config(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    want = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    params = init_params(cfg, device="meta")
    seen, total = set(), 0
    for path, leaf in tree_paths(params):
        assert leaf.device.type == "meta"
        jl = jax_leaf(path)
        ref = want[jl]
        stacked = jl != path
        assert tuple(leaf.shape) == tuple(ref.shape[1:] if stacked
                                          else ref.shape), path
        assert leaf.dtype == DTYPES[str(ref.dtype)], path
        seen.add(jl)
        total += leaf.numel()
    assert seen == set(want)
    assert total == cfg.param_count()


# ---------------------------------------------------------------------------
# sharding specs against the reference (one subprocess, 512 host devices)
# ---------------------------------------------------------------------------

_JAX_SPECS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType, PartitionSpec as P
_make_mesh = jax.make_mesh
def _auto_mesh(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, **kw)
jax.make_mesh = _auto_mesh
from repro.configs import cells, get_config, get_shape
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.models import get_model, input_specs
from repro.optim import OptConfig, init_train_state

def spec(sh):
    return [list(a) if isinstance(a, tuple) else a for a in sh.spec]

def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): spec(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}

out = {}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for arch, shape_name in cells():
        cfg, shape = get_config(arch), get_shape(shape_name)
        model = get_model(cfg)
        sp = input_specs(cfg, shape)
        rec = {}
        if shape.kind == "train":
            state = jax.eval_shape(lambda: init_train_state(
                model.init(jax.random.PRNGKey(0)), OptConfig()))
            rec["state"] = flat(S.state_shardings(mesh, cfg, state))
            rec["batch"] = flat(S.batch_shardings(mesh, cfg, sp["batch"]))
        elif shape.kind == "prefill":
            rec["batch"] = flat(S.batch_shardings(mesh, cfg, sp["batch"]))
        else:
            rec["cache"] = flat(S.cache_shardings(mesh, cfg, sp["cache"],
                                                  shape))
            rec["tokens"] = spec(S.token_shardings(mesh, shape))
        rules = S.make_rules(mesh, cfg)
        rec["rules"] = [list(rules.data_axes), rules.model_axis,
                        rules.seq_parallel]
        out[f"{arch}|{shape_name}|{kind}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_specs") / "specs.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SPECS, str(path)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _port_flat(tree, prefix=""):
    """{JAX leaf path string: spec} of a tree of specs over the port's
    leaves; the per-block leaves of one JAX leaf must agree."""
    out = {}
    for path, spec in tree_paths(tree):
        key = "/".join(str(p) for p in ((prefix,) if prefix else ())
                       + jax_leaf(path))
        js = _spec_json(spec)
        assert out.setdefault(key, js) == js, key
    return out


@pytest.mark.parametrize("mesh_kind", MESH_KINDS)
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_specs_match_reference(jax_specs, arch, shape_name, mesh_kind):
    want = jax_specs[f"{arch}|{shape_name}|{mesh_kind}"]
    cfg, shape = get_config(arch), get_shape(shape_name)
    sp = input_specs(cfg, shape)
    with fake_world(dryrun.MESHES[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        if shape.kind == "train":
            state = init_train_state(init_params(cfg, device="meta"),
                                     OptConfig())
            got = S.state_shardings(mesh, cfg, state)
            flat = {}
            for key, sub in got.items():
                flat.update(_port_flat(sub, key) if key != "step"
                            else {"step": _spec_json(sub)})
            assert flat == want["state"]
            # the parameters' placements: every per-block tensor takes
            # its JAX leaf's spec without the block axis
            pl = S.to_placements(mesh, got["params"])
            assert all(len(p) == mesh.ndim for _, p in tree_paths(pl))
        if shape.kind in ("train", "prefill"):
            got = S.batch_shardings(mesh, cfg, sp["batch"])
            assert {k: _spec_json(v) for k, v in got.items()} == \
                want["batch"]
        else:
            got = S.cache_shardings(mesh, cfg, sp["cache"], shape)
            assert {k: _spec_json(v) for k, v in got.items()} == \
                want["cache"]
            assert _spec_json(S.token_shardings(mesh, shape)) == \
                want["tokens"]
        rules = S.make_rules(mesh, cfg)
        assert [list(rules.data_axes), rules.model_axis,
                rules.seq_parallel] == want["rules"]


# ---------------------------------------------------------------------------
# roofline inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_model_flops_essential_bytes_match_reference(arch, shape_name):
    from repro.configs import get_config as ref_config
    from repro.configs import get_shape as ref_shape
    from repro.launch import hlo_analysis as H
    cfg, shape = get_config(arch), get_shape(shape_name)
    rcfg, rshape = ref_config(arch), ref_shape(shape_name)
    assert roofline.model_flops(cfg, shape) == H.model_flops(rcfg, rshape)
    for chips in dryrun.MESHES.values():
        assert roofline.essential_bytes(cfg, shape, chips) == \
            H.essential_bytes(rcfg, rshape, chips)


def test_roofline_keys_and_card_constants():
    from repro.launch import hlo_analysis as H
    args = dict(flops_per_device=2e12, hbm_bytes_per_device=3e9,
                collective_bytes_per_device=1e8, chips=256,
                model_flops_total=1e14)
    got = roofline.Roofline(**args).to_dict()
    assert list(got) == list(H.Roofline(**args).to_dict())
    assert got["t_compute_s"] == 2e12 / 989e12
    assert got["t_memory_s"] == 3e9 / 3.35e12
    assert got["t_collective_s"] == 1e8 / (400e9 / 8)
    # the 16-wide model axis spans two nodes of 8: no axis stays inside one
    assert roofline.axes_within_node({"data": 16, "model": 16}) == ()
    assert roofline.axes_within_node({"data": 2, "model": 4}) == \
        ("data", "model")


def test_no_tpu_constant_in_port():
    import re
    tpu = re.compile(r"\b(197e12|819e9|50e9)\b")
    hits = [f"{path.name}: {m}"
            for path in (SRC / "repro_torch").rglob("*.py")
            for m in tpu.findall(path.read_text())]
    assert not hits, hits


# ---------------------------------------------------------------------------
# the cost trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_cost_trace_synthetic_loop(device):
    """``tests/test_hlo_cost.py``'s loop: 12 trips of [8,16] @ [16,16] and
    an all-reduce of the product."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with fake_world(4):
        group = make_mesh((4,), ("data",), device_type="cpu").get_group(0)
        x = torch.ones((8, 16), device=device)
        w = torch.ones((16, 16), device=device)
        with CostTrace() as tr:
            for _ in range(12):
                x = x @ w
                dist.all_reduce(x, group=group)
    assert tr.flops == 4096 * 12
    assert tr.collectives["all-reduce"] == 8 * 16 * 4 * 12
    assert tr.collective_bytes == tr.collectives["all-reduce"]
    assert 0 < tr.bytes < 1e6
    assert tr.ops == 24
    # each product's result block is live until the next one replaces it
    assert tr.peak == 2 * 512
    rows = tr.top_ops(2)
    assert {r[1] for r in rows} == {"mm", "allreduce_"}


def _recorded(monkeypatch):
    """Record the shapes of every flash / SSD call's work."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd import ops as sops
    calls = {"flash": [], "ssd": []}
    fw, sw = fops.flash_work, sops.ssd_work

    def flash_work(*a):
        calls["flash"].append(a)
        return fw(*a)

    def ssd_work(*a):
        calls["ssd"].append(a)
        return sw(*a)
    monkeypatch.setattr(fops, "flash_work", flash_work)
    monkeypatch.setattr(sops, "ssd_work", ssd_work)
    return calls


def _skipped_work(calls) -> float:
    """The FLOPs the kernels' masks skip and the JAX prefill computes:
    the masked (query, key) pairs of every causal attention, and the
    pairs above the diagonal of every SSD chunk (C.B^T once a B/C group,
    the weighted sum over p per head)."""
    from repro_torch.kernels.flash_attention import flash_work
    total = 0
    for b, sq, sk, hq, hkv, d, causal, elem in calls["flash"]:
        total += (flash_work(b, sq, sk, hq, hkv, d, False, elem)[0]
                  - flash_work(b, sq, sk, hq, hkv, d, causal, elem)[0])
    for b, s, h, p, n, chunk, _, g in calls["ssd"]:
        full, tail = divmod(s, chunk)
        upper = full * chunk * (chunk - 1) // 2 + tail * (tail - 1) // 2
        total += (2 * n * b * g + 2 * b * h * p) * upper
    return total


def _jax_flops(arch: str, kind: str) -> float:
    import jax
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import hlo_cost
    from repro.models import get_model as ref_model
    from repro.models import input_specs as ref_specs
    from repro.optim import OptConfig as RefOpt
    from repro.optim import init_train_state as ref_state
    from repro.optim import make_train_step as ref_step
    cfg = ref_config(arch).reduced()
    model = ref_model(cfg)
    sp = ref_specs(cfg, RefShape("small", SMALL_SEQ, SMALL_BATCH, kind))
    if kind == "train":
        state = jax.eval_shape(lambda: ref_state(
            model.init(jax.random.PRNGKey(0)), RefOpt()))
        low = jax.jit(ref_step(model, RefOpt())).lower(state, sp["batch"])
    else:
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        if kind == "prefill":
            low = jax.jit(lambda p, b: model.prefill(p, b)).lower(
                params, sp["batch"])
        else:
            low = jax.jit(lambda p, c, t: model.decode_step(p, c, t)).lower(
                params, sp["cache"], sp["tokens"])
    return hlo_cost.analyze(low.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_traced_flops_match_hlo_cost(family, kind, monkeypatch):
    arch = FAMILIES[family]
    calls = _recorded(monkeypatch)
    step, args = dryrun.build_step(
        get_config(arch).reduced(),
        ShapeConfig("small", SMALL_SEQ, SMALL_BATCH, kind), None,
        torch.device("meta"))
    got = dryrun.run_traced(step, args)
    want = _jax_flops(arch, kind)
    if kind == "decode":
        assert got["flops"] == want
        assert got["kernel_calls"] == {}
    elif kind == "prefill":
        assert got["kernel_calls"] and got["kernel_flops"] > 0
        assert got["flops"] < want
        assert got["flops"] + _skipped_work(calls) == want
    else:
        assert got["kernel_calls"] == {}      # training reaches no kernel
        assert abs(got["flops"] - want) <= TRAIN_REL * want, \
            (got["flops"], want)


# ---------------------------------------------------------------------------
# the dry run's cells and command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_cell_writes_reference_keys(family, kind, tmp_path):
    from repro.launch import hlo_analysis as H
    from repro.launch.hlo_cost import COLLECTIVE_KINDS
    arch = FAMILIES[family]
    shape_name = {"train": "train_4k", "prefill": "prefill_32k",
                  "decode": "decode_32k"}[kind]
    rec = dryrun.run_cell(arch, shape_name, "single", tmp_path)
    on_disk = json.loads(
        (tmp_path / f"{arch}__{shape_name}__single.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    for key in ("arch", "shape", "mesh", "chips", "memory_analysis",
                "collectives", "roofline", "essential_bytes_per_device",
                "attn_score_bytes", "convert_bytes", "trace_device",
                "trace_s", "ops", "kernel_calls"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["trace_device"] == "meta"
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes"):
        assert rec["memory_analysis"][key] > 0, key
    assert set(rec["collectives"]) <= set(COLLECTIVE_KINDS)
    # parameters at entry (train), activations' columns (prefill, decode)
    assert rec["collectives"]["all-gather"] > 0
    rl = rec["roofline"]
    assert list(rl) == list(H.Roofline(1, 1, 1, 1).to_dict())
    assert rl["flops_per_device"] > 0 and rl["hbm_bytes_per_device"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    kernels = rec["kernel_calls"]
    if kind == "prefill":
        n_flash = {"dense": 30, "moe": 32, "vlm": 24, "encdec": 36,
                   "ssm": 0, "hybrid": 13}[family]
        n_ssd = {"ssm": 48, "hybrid": 81}.get(family, 0)
        assert kernels == {k: v for k, v in (("flash_attention", n_flash),
                                             ("ssd_scan", n_ssd)) if v}
    else:
        assert kernels == {}


def test_cli_cell_without_jax(tmp_path):
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"rc = dryrun.main(['--arch', 'smollm-135m', '--shape', "
            f"'decode_32k', '--mesh', 'multi', '--dump-ops', '--out', "
            f"{str(tmp_path)!r}])\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "smollm-135m__decode_32k__multi.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["per_device_batch"] == 4
    assert (tmp_path / "smollm-135m__decode_32k__multi.ops.txt").exists()
    assert "[dryrun] OK smollm-135m x decode_32k x multi" in r.stdout


def test_sweep_resumes_and_lists_failures(tmp_path, monkeypatch, capsys):
    """Existing JSONs are skipped; a failing cell is listed and the sweep
    returns 1 after running the rest."""
    done = []

    def fake_run_cell(arch, shape_name, mk, out_dir, **_):
        if arch == "yi-6b":
            raise RuntimeError("boom")
        done.append((arch, shape_name, mk))
        (out_dir / f"{arch}__{shape_name}__{mk}.json").write_text("{}")
    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    (tmp_path / "smollm-135m__train_4k__single.json").write_text("{}")
    assert dryrun.sweep(["single"], False, tmp_path) == 1
    out = capsys.readouterr().out
    assert "3 FAILURES" in out and "'yi-6b', 'train_4k', 'single'" in out
    assert ("smollm-135m", "train_4k", "single") not in done
    assert len(done) == 32 - 1 - 3
    done.clear()
    assert dryrun.sweep(["single"], False, tmp_path) == 1
    assert done == []                      # only yi-6b's three remain


# ---------------------------------------------------------------------------
# the kernels' meta paths
# ---------------------------------------------------------------------------

def test_flash_meta_path_reports_work():
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty((2, 300, 9, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 300, 3, 64), dtype=torch.bfloat16, device="meta")
    fa.reset_launches()
    with CostTrace() as tr:
        o = fa.flash_attention(q, k, k, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape and \
        o.dtype == torch.bfloat16
    assert fa.LAUNCHES["flash_attention"] == 0
    flops, nbytes = fa.flash_work(2, 300, 300, 9, 3, 64, True, 2)
    assert flops == 4 * 2 * 9 * 64 * (300 * 301 // 2)
    assert tr.kernel_calls == {"flash_attention": 1}
    assert tr.flops == tr.kernel_flops == flops and tr.bytes == nbytes
    # the checks of the kernel hold on meta too
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           k[..., :48].contiguous())


def test_ssd_meta_path_reports_work():
    from repro_torch.kernels import ssd
    b, s, h, p, n = 2, 300, 4, 64, 128
    x = torch.empty((b, s, h, p), dtype=torch.bfloat16, device="meta")
    dt = torch.empty((b, s, h), device="meta")
    A = torch.empty((h,), device="meta")
    B = torch.empty((b, s, n), dtype=torch.bfloat16, device="meta")
    ssd.reset_launches()
    with CostTrace() as tr:
        y, st = ssd.ssd_scan(x, dt, A, B, B, chunk=128)
    assert y.shape == x.shape and y.dtype == x.dtype and \
        y.device.type == "meta"
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    assert ssd.LAUNCHES["ssd_scan"] == 0
    cb, rest, nbytes = ssd.ssd_work(b, s, h, p, n, 128, 2)
    assert tr.kernel_calls == {"ssd_scan": 1}
    assert tr.flops == cb + rest and tr.bytes == nbytes


def test_cpu_kernel_call_counts_work_not_plain_ops():
    """On the CPU the plain version runs, but the trace counts the
    kernel's work, as on the card and on meta."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 40, 4, 16), generator=g)
    k = torch.randn((1, 40, 2, 16), generator=g)
    with CostTrace() as tr:
        fa.flash_attention(q, k, k, causal=False)
    flops, nbytes = fa.flash_work(1, 40, 40, 4, 2, 16, False, 4)
    assert tr.flops == flops and tr.bytes == nbytes
    assert tr.kernel_calls == {"flash_attention": 1}


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_quickstart_matches_reference():
    from repro.cachesim import SimConfig as RefConfig
    from repro.cachesim import get_trace as ref_trace
    from repro.cachesim.simulator import run_policies as ref_run
    n = 6000
    got = _example("torch_quickstart").main(["--device", "cpu",
                                              "--requests", str(n)])
    want = ref_run(ref_trace("gradle", n, seed=0),
                   RefConfig(n_caches=3, cache_size=2_000,
                             costs=(1.0, 2.0, 3.0), miss_penalty=100.0,
                             bpe=14.0, update_interval=512),
                   policies=("pi", "fno", "fna", "fna_cal"))
    for policy, ref in want.items():
        assert got[policy].mean_cost == ref.mean_cost, policy
        assert got[policy].hit_ratio == ref.hit_ratio, policy
        assert got[policy].neg_accesses == ref.neg_accesses, policy


def test_example_scenario_sweep_runs():
    cells_ = _example("torch_scenario_sweep").main(
        ["hetero_tiers", "3000", "--device", "cpu"])
    assert cells_ and all("pi" in c["cost"] for c in cells_)


def test_example_serve_prefix_cache_runs():
    out = _example("torch_serve_prefix_cache").main(
        ["--requests", "12", "--device", "cpu"])
    assert set(out) == {"fno", "fna", "fna_cal", "pi"}
    assert all(st.requests == 12 and st.prefills >= 1
               for st in out.values())


def test_example_train_lm_runs():
    assert _example("torch_train_lm").main(["--steps", "3",
                                            "--device", "cpu"]) == 0


def test_example_elastic_restart_is_bit_exact():
    loss = _example("torch_elastic_restart").main(
        ["--device", "cpu", "--steps", "6", "--kill-at", "3"])
    assert np.isfinite(loss)
