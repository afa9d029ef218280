"""``prefill_graph_share`` against the program's counters set by hand, on a
program without the counters, and in a traced CPU run of each cell (no
prefill on the card: nothing to read)."""
import importlib.util
from pathlib import Path

import pytest

from bench import harness
from bench.conftest import TINY, TINY_TRAFFIC

BENCH = Path(__file__).resolve().parent


def _reader():
    spec = importlib.util.spec_from_file_location(
        "t_prefill_graph_share", BENCH / "metrics/prefill_graph_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counters():
    from repro_torch import tracing
    tracing.reset_counters()
    yield tracing
    tracing.reset_counters()


def test_share_of_replayed_prefills(counters):
    read = _reader().read
    assert read(None) is None                    # no prefill counted
    counters.count("prefill.graph_captures")
    assert read(None) is None                    # a capture is no replay
    counters.count("decode.graph_replays", 7)
    assert read(None) is None                    # decode steps are not read
    counters.count("prefill.graph_replays", 99)
    assert read(None) == 1.0
    counters.count("prefill.eager_runs")
    assert read(None) == 0.99
    counters.reset_counters()
    counters.count("prefill.eager_runs", 4)
    assert read(None) == 0.0


def test_program_without_the_counters_reads_nothing(monkeypatch, counters):
    counters.count("prefill.graph_replays", 5)
    monkeypatch.delattr(counters, "counters")
    assert _reader().read(None) is None


@pytest.mark.parametrize("cell", ["mamba2-370m.docqa",
                                  "mamba2-370m.unshared"])
def test_traced_cpu_run_leaves_the_share_out(cell, counters):
    c = harness.load_cell(cell, model_over=TINY["mamba2-370m"],
                          traffic_over=TINY_TRAFFIC)
    assert "prefill_graph_share" in [m["name"] for m in c.per_layer]
    result, checks = harness.run_cell(c, 2**31 + 17, 1.0, True,
                                      device="cpu", t_start=0.0,
                                      requests=6)
    assert result["correct"], checks
    assert "prefill_graph_share" not in result["metrics"]
    assert "prefill_ms" in result["metrics"]
    assert counters.counters().get("prefill.eager_runs", 0) == 0
