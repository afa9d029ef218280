"""The port's span recorder (``repro_torch.tracing``): off, it records
nothing at the cost of a call; on, the serving path's spans nest as
``route`` > ``prefill`` on a miss, then ``decode`` > ``decode.step`` a
token, one request id across them, on the clock of ``torch.profiler``; the
serving launcher writes them as Chrome-trace JSON."""
import json
import re
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import (ClusterConfig, PrefixServeCluster,
                                 ServeEngine)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and empty; tiny
    eager ops run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()
    torch.set_num_threads(n)


def test_span_off_records_nothing_and_returns_the_shared_noop():
    with tracing.span("route", request=3) as s:
        assert s is None
    assert tracing.span("decode") is tracing.NOOP
    assert tracing.spans() == []
    tracing.enable()
    with tracing.span("x"):
        pass
    tracing.disable()
    assert tracing.span("x") is tracing.NOOP
    assert [s.name for s in tracing.spans()] == ["x"]


def test_span_off_costs_under_half_a_microsecond():
    """Timed over 10**6 calls, the fastest of five rounds (the host is
    shared)."""
    span, n = tracing.span, 1_000_000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with span("decode.step"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best <= 0.5e-6, best


def _served(labels, n_out=3):
    """Serve ``labels`` through a tiny mamba2-370m on the CPU with the
    recorder on; returns (the cluster, each request's hit)."""
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = ServeEngine(cfg, params=params, device="cpu")
    cluster = PrefixServeCluster(ClusterConfig(n_nodes=2, node_capacity=4,
                                               update_interval=2), seed=1)
    docs = {k: np.random.default_rng(k).integers(0, cfg.vocab, (1, 12))
            for k in set(labels)}
    hits = []
    tracing.enable()
    for label in labels:
        missed = []

        def make_kv():
            missed.append(True)
            return engine.prefill(docs[label], max_len=12 + n_out + 2)[1]

        kv, _ = cluster.request(label, make_kv)
        engine.decode(kv, np.zeros(1, np.int32), n_out)
        hits.append(not missed)
    tracing.disable()
    return cluster, hits


def test_span_tree_of_served_requests():
    labels, n_out = [5, 5, 7, 5], 3
    cluster, hits = _served(labels, n_out)
    spans = tracing.spans()
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in spans)
    assert [s.id for s in spans] == list(range(len(spans)))
    assert not hits[0] and sum(not h for h in hits) == cluster.stats.prefills
    by_request = {}
    for s in spans:
        by_request.setdefault(s.request, []).append(s)
    assert sorted(by_request) == list(range(len(labels)))
    for rid, hit in enumerate(hits):
        mine = by_request[rid]
        route, rest = mine[0], mine[1:]
        assert (route.name, route.parent) == ("route", None)
        if not hit:
            prefill, rest = rest[0], rest[1:]
            assert (prefill.name, prefill.parent) == ("prefill", route.id)
            assert route.start_ns <= prefill.start_ns <= prefill.end_ns \
                <= route.end_ns
        decode, steps = rest[0], rest[1:]
        assert (decode.name, decode.parent) == ("decode", None)
        assert decode.start_ns >= route.end_ns
        assert [(s.name, s.parent) for s in steps] == \
            [("decode.step", decode.id)] * n_out
        assert all(decode.start_ns <= s.start_ns <= s.end_ns <= decode.end_ns
                   for s in steps)


def test_span_starts_with_a_record_function_on_the_profilers_clock():
    """A span and a ``record_function`` opened around the same code start
    within 1 ms of each other: the spans need no offset to lie on the
    profile's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.span("clock"), record_function("clock.rf"):
                torch.ones(64).sum()
    tracing.disable()
    mine = [s.start_ns for s in tracing.spans()]
    theirs = sorted(ev.start_ns() for ev in prof.profiler.kineto_results
                    .events() if ev.name() == "clock.rf")
    assert len(mine) == len(theirs) == 3
    assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000


def test_serve_launcher_writes_spans_and_times_decode_alone(tmp_path,
                                                            capsys):
    """``--spans`` writes the run's spans as Chrome-trace JSON; ``tok/s``
    divides the decoded tokens by the decode calls' time, not by a wall
    that holds the prefills; the ``decoded`` line keeps its format."""
    from repro_torch.launch.serve import main
    path = tmp_path / "spans.json"
    argv = ["--arch", "mamba2-370m", "--device", "cpu", "--requests", "6",
            "--prefix-len", "8", "--decode-steps", "2", "--spans", str(path)]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert tracing.span("after") is tracing.NOOP
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("route") == 6 and names.count("decode") == 6
    assert names.count("decode.step") == 12
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert f"wrote {len(events)} spans" in out
    decoded = re.search(r"\[serve\] decoded tokens=(\d+) in ([0-9.]+)s "
                        r"\(prefill ([0-9.]+)s\)", out)
    tokens, wall = int(decoded.group(1)), float(decoded.group(2))
    assert tokens == 12
    tok_s = float(re.search(r"tok/s=([0-9,]+)", out).group(1).replace(
        ",", ""))
    decode_s = sum(e["dur"] for e in events if e["name"] == "decode") / 1e6
    assert tok_s > tokens / wall
    assert tok_s == pytest.approx(tokens / decode_s, rel=0.1, abs=1)


def test_an_exception_passes_through_a_span_on_and_off():
    for on in (False, True):
        if on:
            tracing.enable()
        with pytest.raises(ValueError):
            with tracing.span("prefill"):
                raise ValueError("kept")
        tracing.disable()
    (s,) = tracing.spans()
    assert s.end_ns is not None
