"""The yardstick's arithmetic against hand counts: the SSD's operations and
bytes, the prefill's model FLOPs, the roofline and idle readers on a
trace made by hand."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import peaks, trace

METRICS = Path(__file__).resolve().parent / "metrics"
H100 = "NVIDIA H100 80GB HBM3"


def _metric(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ssd_work_by_hand():
    ssd = _metric("ssd_roofline")
    # s 6 in chunks of 4: 4*5/2 + 2*3/2 = 13 kept (i >= j) pairs
    pairs = sum(1 for c0 in (0, 4) for i in range(c0, min(c0 + 4, 6))
                for j in range(c0, i + 1))
    assert pairs == 13
    cb, rest, nbytes = ssd.ssd_work(1, 6, 2, 4, 3, 4, 2)
    assert cb == 2 * 3 * 13
    assert rest == 2 * (2 * 4 * 13 + 4 * 6 * 4 * 3)
    # x [6,2,4], B and C [6,3] two bytes; dt [6,2], A [2], state [2,4,3]
    assert nbytes == 2 * (48 + 48 + 18 + 18) + 4 * (12 + 2 + 24)


def _cfg(**kw):
    base = dict(family="ssm", d_model=8, d_inner=16, ssm_state=4,
                ssm_heads=2, ssm_headdim=8, ssm_chunk=4, n_layers=4,
                vocab_padded=32)
    base.update(kw)
    return SimpleNamespace(**base)


def test_prefill_flops_by_hand():
    mfu = _metric("prefill_mfu")
    ssd = _metric("ssd_roofline")
    s, c = 6, _cfg()
    cb, rest, _ = ssd.ssd_work(1, 6, 2, 8, 4, 4, 2)
    # in: 8 x (2*16 + 2*4 + 2); out: 16 x 8; head at the last token
    mamba = 2 * 6 * (8 * (32 + 8 + 2) + 16 * 8) + cb + rest
    assert mfu.prefill_flops(c, s) == 4 * mamba + 2 * 8 * 32
    for family in ("dense", "hybrid"):
        assert mfu.prefill_flops(_cfg(family=family), s) is None


def _run(ops, window, cfg, s=6, kind=H100):
    return SimpleNamespace(trace=trace.DeviceTrace(ops, window), cfg=cfg,
                           traffic={"prefix_len": s},
                           device={"kind": kind}, requests=[])


def test_rooflines_and_idle_on_a_hand_made_trace():
    ssd = _metric("ssd_roofline")
    c = _cfg()
    card = peaks.of(H100)
    ops = []
    for i, st in enumerate(ssd.STAGES * 3):
        ops.append((f"void {st}<__nv_bfloat16, 64>(float*)", i * 1e-3,
                    0.5e-3))
    ops.append(("void other_kernel(float*)", 0.1, 2e-3))
    run = _run(ops, 1.0, c)
    got = ssd.read(run)
    assert got == pytest.approx(100 * 3 * ssd.bound_s(c, 6, card) / 7.5e-3)
    idle = _metric("idle_share").read(run)
    assert idle == pytest.approx(100 * (1 - (15 * 0.5e-3 + 2e-3)))
    # nothing to read: no value (never 0)
    assert ssd.read(_run([], 1.0, c)) is None
    assert ssd.read(_run(ops[15:], 1.0, c)) is None
    assert ssd.read(_run(ops, 1.0, c, kind="another card")) is None


@pytest.mark.parametrize("n, by", [(128, "bytes"), (512, "operations")])
def test_ssd_bound_counts_every_operation_at_the_bf16_peak(n, by):
    """Every product of the scan is a bf16 matrix product, so the bound is
    the larger of all operations over the bf16 peak and bytes over the
    bandwidth.  At mamba2-370m's 32k prefill (state 128) the bytes set it,
    0.0867 ms; a state of 512 makes the operations set it."""
    ssd = _metric("ssd_roofline")
    card = peaks.of(H100)
    s = 32768
    c = _cfg(ssm_heads=32, ssm_headdim=64, ssm_state=n, ssm_chunk=256)
    cb, rest, nbytes = ssd.ssd_work(1, s, 32, 64, n, 256, 2)
    ops_s, bytes_s = (cb + rest) / 989e12, nbytes / 3.35e12
    assert ssd.bound_s(c, s, card) == max(ops_s, bytes_s)
    assert (bytes_s >= ops_s) == (by == "bytes")
    if n == 128:
        assert ssd.bound_s(c, s, card) == pytest.approx(8.67e-5, rel=1e-3)


def test_gaps_busy_and_labels():
    tr = trace.DeviceTrace(
        [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 1.0)], 5.0,
        host=[(1.6, 2.9, "aten::mm"), (2.0, 2.2, "aten::copy_")],
        phases=[(0.0, 5.0, "bench.decode")])
    assert tr.gaps() == [(1.5, 1.5), (4.0, 1.0)]
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.labels([0.5, 2.1, 2.5, 4.5]) == [
        "bench.decode", "bench.decode/aten::copy_", "bench.decode/aten::mm",
        "bench.decode"]
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(1.0)
    assert sorted(n for n, _ in bd["idle_gaps"]) == ["bench.decode",
                                                     "bench.decode/aten::mm"]
