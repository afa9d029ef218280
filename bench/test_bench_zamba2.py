"""The cell ``zamba2-7b-instruct.docqa`` at a CPU test's size: the comparison
that decides ``correct`` passes the program and fails the control (the
float32 reference computed in fp8, the step below the bf16 the
configuration states) under limits set by the benchmark's rule; a broken
timed path is not correct; and the cell's four per-layer readers against
hand counts on traces and counters made by hand."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import harness, peaks, trace
from bench.conftest import TINY_TRAFFIC

CELL = "zamba2-7b-instruct.docqa"
#: the published configuration at a tiny size with every mechanism: shared
#: blocks before layers 1 and 3 (alternating), [x, embeddings] into them,
#: 4 heads of 32 (2 d / heads) at scale (32/2)^-1/2, GELU with rank-8
#: adapters, 8 Mamba heads in 2 B/C groups
TINY = dict(n_layers=4, hybrid_layer_ids=[1, 3], d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=32, d_ff=96, vocab=256, ssm_state=16,
            ssm_headdim=16, ssm_chunk=16, adapter_rank=8,
            attn_scale=16 ** -0.5)
SEEDS = [2**31 + 41, 2**31 + 42, 2**31 + 43]
NUMBERS = ("prefill_logit_err", "decode_gap")
REQUESTS = 24
METRICS = Path(__file__).resolve().parent / "metrics"
H100 = "NVIDIA H100 80GB HBM3"


def _cell():
    return harness.load_cell(CELL, model_over=TINY,
                             traffic_over=TINY_TRAFFIC)


@pytest.fixture(scope="module")
def readings():
    """[(program's numbers, control's numbers) a seed] (on one thread: a
    module's fixture is set up before the function-scoped one that sets
    it for the tests)."""
    cell, out, threads = _cell(), [], torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in SEEDS:
            sv = harness.serve_cell(cell, seed, 600.0, False, device="cpu",
                                    t_start=0.0, requests=REQUESTS)
            out.append(tuple(
                {k: c["value"] for k, c in harness.verify(
                    cell, sv, seed, control=control)[0].items()}
                for control in (False, True)))
    finally:
        torch.set_num_threads(threads)
    return out


def _limits(rows):
    lim = {"route_mismatch": {"limit": 0}}
    for k in NUMBERS:
        lower = max(p[k] for p, _ in rows)
        upper = min(c[k] for _, c in rows)
        lim[k] = {"limit": (lower + upper) / 2}
    return lim


def test_control_reads_past_the_program(readings):
    lower = max(p["prefill_logit_err"] for p, _ in readings)
    assert 0 < 3 * lower <= min(c["prefill_logit_err"] for _, c in readings)
    for p, _ in readings:
        assert p["route_mismatch"] == 0


def test_limits_by_the_rule_pass_the_program_and_fail_the_control(
        readings):
    lim = _limits(readings)
    for prog, ctl in readings:
        assert all(prog[k] <= lim[k]["limit"] for k in NUMBERS)
        assert any(ctl[k] > lim[k]["limit"] for k in NUMBERS)


def _run(limits, patch=None):
    cell = _cell()
    cell.limits = limits
    return harness.run_cell(cell, SEEDS[0], 600.0, False, device="cpu",
                            t_start=0.0, patch=patch, requests=REQUESTS)


def _no_adapter(server):
    """The shared block's MLP without its per-application adapters: a
    prefill that leaves part of the published mathematics out."""
    for ap in server.engine.params["apps"]:
        ap["adapter_b"] = ap["adapter_b"] * 0


def test_a_sound_run_is_correct_and_a_broken_one_is_not(readings):
    lim = _limits(readings)
    result, checks = _run(lim)
    assert result["correct"], checks
    params = {}

    def patch(server):
        # the program's own copy of the weights, so the reference still
        # reads the benchmark's
        params.update(server.engine.params)
        server.engine.params = dict(
            params, apps=[dict(ap) for ap in params["apps"]])
        _no_adapter(server)
    result, checks = _run(lim, patch)
    assert not result["correct"]
    assert checks["prefill_logit_err"]["value"] > \
        lim["prefill_logit_err"]["limit"]


def _metric(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(**kw):
    base = dict(family="hybrid", hybrid_layer_ids=(1, 3), n_layers=4,
                d_model=8, d_inner=16, ssm_state=4, ssm_heads=4,
                ssm_headdim=4, ssm_chunk=4, ssm_groups=2,
                n_heads=2, n_kv_heads=2, head_dim=8, d_ff=12,
                adapter_rank=2, vocab_padded=32)
    base.update(kw)
    return SimpleNamespace(**base)


def test_hybrid_prefill_flops_by_hand():
    mfu = _metric("hybrid_prefill_mfu")
    s, c = 6, _cfg()
    # grouped SSD, s 6 in chunks of 4: 13 kept pairs; C.B^T once a group
    cb = 2 * (2 * 4 * 13)
    rest = 4 * (2 * 4 * 13 + 4 * 6 * 4 * 4)
    # in: 8 x (2*16 + 2*2*4 + 4); out: 16 x 8
    mamba = 2 * 6 * (8 * (32 + 16 + 4) + 16 * 8) + cb + rest
    # q/k/v from 16 to 2 x 8 each; o 16 -> 8; gate/up 8 -> 24; adapter
    # 8 -> 2 -> 24; down 12 -> 8; linear 8 -> 8; attention 21 pairs
    shared = 2 * 6 * (16 * 3 * 16 + 16 * 8 + 8 * 24 + 2 * 8 + 2 * 24 +
                      12 * 8 + 8 * 8) + 4 * 2 * 8 * 21
    assert mfu.prefill_flops(c, s) == 4 * mamba + 2 * shared + 2 * 8 * 32
    assert mfu.prefill_flops(_cfg(hybrid_layer_ids=()), s) is None
    assert mfu.prefill_flops(_cfg(family="ssm"), s) is None
    run = SimpleNamespace(
        cfg=c, traffic={"prefix_len": s}, device={"kind": H100},
        requests=[SimpleNamespace(hit=False, prefill_s=0.5),
                  SimpleNamespace(hit=True, prefill_s=0.0),
                  SimpleNamespace(hit=False, prefill_s=1.5)])
    want = 100 * mfu.prefill_flops(c, s) * 2 / (2.0 * 989e12)
    assert mfu.read(run) == pytest.approx(want)


def _run_on(ops, cfg, s=6):
    return SimpleNamespace(trace=trace.DeviceTrace(ops, 1.0), cfg=cfg,
                           traffic={"prefix_len": s},
                           device={"kind": H100}, requests=[])


def test_flash_and_grouped_ssd_rooflines_on_a_hand_made_trace():
    flash, ssd = _metric("flash_roofline"), _metric("hybrid_ssd_roofline")
    card = peaks.of(H100)
    c = _cfg()
    ops = [("void (anonymous namespace)::flash_wgmma_kernel<8>(CUtensorMap)",
            0.0, 2e-6)] * 2
    for st in ssd._stages() * 3:
        ops.append((f"void {st}<__nv_bfloat16, 4>(float*)", 0.0, 1e-6))
    ops.append(("ampere_bf16_gemm", 0.0, 1.0))
    run = _run_on(ops, c)
    # causal [1, 6, 2/2, 8]: 21 pairs, 4 * 2 * 8 * 21 flops; q, k, v, o
    # of 6 x 2 x 8 two-byte values
    fl, nb = 4 * 2 * 8 * 21, 2 * 4 * 6 * 2 * 8
    bound = max(fl / card["bf16_flops"], nb / card["hbm_bytes_per_s"])
    assert flash.read(run) == pytest.approx(100 * 2 * bound / 4e-6)
    cb, rest, nbytes = ssd.ssd_work(1, 6, 4, 4, 4, 4, 2, 2)
    assert cb == 2 * 2 * 4 * 13
    # x [6,4,4], B and C [6,2,4] two bytes; dt [6,4], A [4], state [4,4,4]
    assert nbytes == 2 * (96 + 96 + 48 + 48) + 4 * (24 + 4 + 64)
    sb = max((cb + rest) / card["bf16_flops"],
             nbytes / card["hbm_bytes_per_s"])
    assert ssd.read(run) == pytest.approx(100 * 3 * sb / 15e-6)
    assert flash.read(_run_on([("ampere_bf16_gemm", 0.0, 1.0)], c)) is None
    assert ssd.read(_run_on([], c)) is None


def test_prefix_cache_mb_reads_the_counters():
    from repro_torch import tracing
    mb = _metric("prefix_cache_mb")
    before = tracing.counters()
    tracing.reset_counters()
    try:
        assert mb.read(None) is None
        for _ in range(3):
            tracing.count("hybrid.prefills")
            tracing.count("hybrid.prefix_kv_bytes", 1_526_726_656)
            tracing.count("hybrid.prefix_state_bytes", 152_243_712)
        assert mb.read(None) == pytest.approx(1678.970368)
    finally:
        tracing.reset_counters()
        for k, v in before.items():
            tracing.count(k, v)


def test_a_tiny_run_reports_the_cells_metrics(readings):
    """A traced run at the tiny size reads the cell's per-layer metrics
    that need no card (the rooflines and the MFU need the card's trace
    and peaks); the prefix's bytes are those of the cache the model's
    ``cache_spec`` gives.  The counters are process-wide and a benchmark
    process runs one cell, so they start from zero here too: another
    test's prefills in this process would count other caches."""
    from repro_torch import tracing
    from repro_torch.models import get_model
    cell = _cell()
    cell.limits = _limits(readings)
    before = tracing.counters()
    tracing.reset_counters()
    try:
        result, _ = harness.run_cell(cell, SEEDS[1], 600.0, True,
                                     device="cpu", t_start=0.0,
                                     requests=REQUESTS)
    finally:
        tracing.reset_counters()
        for k, v in before.items():
            tracing.count(k, v)
    got = result["metrics"]
    assert result["correct"]
    assert {"route_ms", "prefill_ms", "kv_hit_ratio",
            "prefix_cache_mb"} <= set(got)
    spec = get_model(harness.Server(cell, 0, "cpu").cfg).cache_spec(
        1, cell.traffic["prefix_len"] + cell.traffic["n_out"] + 2)
    import math
    want = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for name, (shape, dt) in spec.items() if name != "len")
    assert got["prefix_cache_mb"]["value"] == pytest.approx(want / 1e6)
