"""``resident_miss_ratio`` against a count by hand over the docqa stream, on
a program without the counter, and in a traced CPU run of each cell."""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import harness, streams
from bench.conftest import TINY, TINY_TRAFFIC

BENCH = Path(__file__).resolve().parent
KEYS = ("requests", "kv_hits", "prefills", "probes", "neg_probes")


def _reader():
    spec = importlib.util.spec_from_file_location(
        "t_resident_miss_ratio", BENCH / "metrics/resident_miss_ratio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(traffic, n):
    """The window's counters after set-up, and the misses whose document
    its designated node held before the request, counted by hand."""
    from repro_torch.serving import ClusterConfig, PrefixServeCluster
    cluster = PrefixServeCluster(ClusterConfig(**traffic["cluster"]),
                                 seed=traffic["stream"]["router_seed"])
    labels = [int(x) for x in streams.stream(traffic)]
    n0 = traffic["warm"]["requests"]
    for label in labels[:n0]:
        cluster.request(label)
    st = cluster.stats
    base = {k: getattr(st, k) for k in KEYS}
    held = 0
    for label in labels[n0:n0 + n]:
        node = cluster.nodes[label % len(cluster.nodes)]
        was, prefills = label in node.lru, st.prefills
        cluster.request(label)
        held += was and st.prefills > prefills
    return {k: getattr(st, k) - base[k] for k in KEYS}, held


def test_docqa_window_by_hand():
    traffic = json.loads((BENCH / "traffic/docqa.json").read_text())
    stats, held = _window(traffic, 170)
    run = SimpleNamespace(traffic=traffic, stats=stats)
    assert (held, stats["prefills"]) == (76, 106)
    assert _reader().read(run) == held / stats["prefills"]
    # a replay that does not reproduce the run's counters reads nothing
    run.stats = dict(stats, kv_hits=stats["kv_hits"] + 1)
    assert _reader().read(run) is None


def test_unshared_window_reads_zero():
    traffic = json.loads((BENCH / "traffic/unshared.json").read_text())
    stats, held = _window(traffic, 60)
    assert held == 0
    assert _reader().read(SimpleNamespace(traffic=traffic,
                                          stats=stats)) == 0.0


def test_program_without_the_counter_reads_nothing(monkeypatch):
    from repro_torch.serving import PrefixServeCluster
    traffic = json.loads((BENCH / "traffic/docqa.json").read_text())
    stats, _ = _window(traffic, 20)
    monkeypatch.setattr(PrefixServeCluster, "stats", property(
        lambda self: SimpleNamespace(**{k: 0 for k in KEYS})))
    assert _reader().read(SimpleNamespace(traffic=traffic,
                                          stats=stats)) is None


@pytest.mark.parametrize("cell", ["mamba2-370m.docqa",
                                  "mamba2-370m.unshared"])
def test_traced_cpu_run_reads_the_ratio(cell):
    c = harness.load_cell(cell, model_over=TINY["mamba2-370m"],
                          traffic_over=TINY_TRAFFIC)
    result, checks = harness.run_cell(c, 2**31 + 11, 1.0, True,
                                      device="cpu", t_start=0.0,
                                      requests=12)
    assert result["correct"], checks
    value = result["metrics"]["resident_miss_ratio"]["value"]
    assert 0.0 <= value <= 1.0
    if cell.endswith("unshared"):
        assert value == 0.0
