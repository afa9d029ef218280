"""The port's content-addressed artifact store (``repro_torch.cachesim.
store``) on the CPU.

  * round trips, each bit-identical: a sweep (advert event streams and
    token state included), the decision tables of a grid (a warm run
    preloads them and computes no sweep), and a chunked sweep spilled to
    memmaps under the store's ``spill/``;
  * the port's and the reference's stores stay apart: an entry written by
    the JAX package's ``ArtifactStore`` is never a hit for the port, nor
    the reverse; a table keyed on the card is never a hit for a CPU run
    (checked by key, no card needed);
  * corrupt entries read as misses; every golden scenario warm from the
    store computes zero sweeps and returns identical records;
  * the maintenance tool ``python -m repro_torch.tools.store_tool``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.cachesim.systemstate as systemstate
from repro.cachesim import SimConfig as RefSimConfig
from repro.cachesim import Simulator as RefSimulator
from repro.cachesim.store import ArtifactStore as RefArtifactStore
from repro.cachesim.systemstate import SystemTrace as RefSystemTrace
from repro_torch.cachesim import (GOLDEN_SCENARIOS, ArtifactStore,
                                  RunReport, SimConfig, Simulator,
                                  SystemTrace, get_scenario, get_trace,
                                  run_cells, run_grid, run_scenario)
from repro_torch.cachesim.engine import table_keys_for

REPO = Path(__file__).resolve().parents[1]
ADVERT_CFG = dict(cache_size=400, advert_policy="self_adjusting",
                  advert_bandwidth=4.0, advert_threshold=0.05)


def _assert_payloads_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _assert_same(got, want, ctx):
    assert dataclasses.asdict(got) == dataclasses.asdict(want), ctx
    assert (got.advert_events, got.advert_bytes) == \
        (want.advert_events, want.advert_bytes), ctx


def test_sweep_round_trip_is_bit_identical(tmp_path):
    """save_sweep -> load_sweep: the payload re-serialises byte for byte,
    the advert streams are equal, and every policy replays the hydrated
    sweep to the cold one's results."""
    trace = get_trace("wiki", 6_000, seed=2)
    cfg = SimConfig(**ADVERT_CFG)
    st = SystemTrace.compute(Simulator(cfg, "cpu"), trace)
    store = ArtifactStore(tmp_path)
    store.save_sweep(st)
    hyd = store.load_sweep(trace, st.key, device="cpu")
    assert hyd is not None and hyd.device == torch.device("cpu")
    assert hyd.plan_cache == {} and hyd.from_fresh == st.from_fresh
    _assert_payloads_equal(hyd.to_arrays(), st.to_arrays())
    streams = st.advert_streams()
    assert len(streams) == cfg.n_caches and sum(len(i) for i, _ in streams)
    for (a_ins, a_b), (b_ins, b_b) in zip(streams, hyd.advert_streams()):
        assert a_ins.tobytes() == b_ins.tobytes()
        assert a_b.tobytes() == b_b.tobytes()
    for p in ("fna", "fna_cal", "fno", "pi"):
        pcfg = dataclasses.replace(cfg, policy=p)
        cold = Simulator(pcfg, "cpu").run(trace, system=st)
        warm = Simulator(pcfg, "cpu").run(trace, system=hyd)
        _assert_same(warm, cold, p)


def test_advert_streams_equal_reference():
    trace = get_trace("wiki", 6_000, seed=2)
    st = SystemTrace.compute(Simulator(SimConfig(**ADVERT_CFG), "cpu"), trace)
    ref = RefSystemTrace.compute(RefSimulator(RefSimConfig(**ADVERT_CFG)),
                                 trace)
    for (a_ins, a_b), (b_ins, b_b) in zip(st.advert_streams(),
                                          ref.advert_streams()):
        assert a_ins.tobytes() == b_ins.tobytes()
        assert a_b.tobytes() == b_b.tobytes()


def test_from_arrays_takes_the_reference_payload():
    """``from_arrays`` hydrates the JAX package's own payload (the layouts
    are identical), and re-serialises it byte for byte."""
    trace = get_trace("gradle", 4_000, seed=1)
    kw = dict(cache_size=500, update_interval=120)
    ref = RefSystemTrace.compute(RefSimulator(RefSimConfig(**kw)), trace)
    key = SystemTrace.system_key(SimConfig(**kw))
    st = SystemTrace.from_arrays(ref.to_arrays(), key, trace)
    assert st.device.type == "cpu" and st.key == key
    _assert_payloads_equal(st.to_arrays(), ref.to_arrays())


PENALTIES = (25.0, 100.0, 500.0)


_BASE = SimConfig(n_caches=4, costs=(1.0, 2.0, 3.0, 1.5), cache_size=800,
                  update_interval=200)


def _penalty_grid(store, alg):
    traces = {"gradle": get_trace("gradle", 4_000, seed=0)}
    return run_grid(traces, dataclasses.replace(_BASE, alg=alg),
                    "miss_penalty", PENALTIES, policies=("fna", "fno", "pi"),
                    store=store, device="cpu")


@pytest.mark.parametrize("alg", ["exhaustive", "ds_pgm"])
def test_table_round_trip_is_bit_identical(tmp_path, alg):
    """A decision-side grid saves one sweep and every table; a warm run
    computes no sweep, preloads every table (no build) and returns the
    same results; each stored table equals the cold build bit for bit."""
    cold = _penalty_grid(None, alg)
    store = ArtifactStore(tmp_path)
    populated = _penalty_grid(store, alg)
    assert store.stats["sweep_misses"] == 1
    n_tables = len(list((tmp_path / "tables").glob("*.npz")))
    assert n_tables == 6                     # (fna, fno) x three penalties
    before = systemstate.SWEEPS_COMPUTED
    warm_store = ArtifactStore(tmp_path)
    warm = _penalty_grid(warm_store, alg)
    assert systemstate.SWEEPS_COMPUTED == before
    assert warm_store.stats["sweep_hits"] == 1
    assert warm_store.stats["table_hits"] == n_tables
    assert warm_store.stats["writes"] == 0
    for grid in (populated, warm):
        for key, cell in grid.items():
            for p, res in cell.items():
                _assert_same(res, cold[key][p], (key, p))
    trace = np.asarray(get_trace("gradle", 4_000, seed=0), np.uint64)
    cfgs = [dataclasses.replace(_BASE, alg=alg, miss_penalty=m)
            for m in PENALTIES]
    report = RunReport()
    run_cells(trace, cfgs, ("fna", "fno"), device="cpu", report=report)
    st = report.system
    keys = table_keys_for(cfgs, ("fna", "fno", "pi"))
    assert len(keys) == n_tables and set(keys) == set(st.plan_cache)
    for key in keys:
        tab = warm_store.load_table(store.trace_digest(trace), st.key, key,
                                    "cpu")
        assert tab.dtype == torch.int64, key
        assert torch.equal(tab, st.plan_cache[key]), key


def test_spill_round_trip_is_bit_identical(tmp_path):
    """A chunked sweep spilled through the store (``spill=store``) writes
    its memmaps under ``<root>/spill`` (never entries), equals the in-RAM
    sweep byte for byte, and round-trips through the store unchanged."""
    trace = get_trace("scarab", 5_000, seed=3)
    cfg = SimConfig(cache_size=600, update_interval=150)
    store = ArtifactStore(tmp_path)
    ram = SystemTrace.compute(Simulator(cfg, "cpu"), trace)
    spilled = SystemTrace.compute(Simulator(cfg, "cpu"), trace,
                                  chunk_size=777, spill=store)
    assert isinstance(spilled.pats, np.memmap)
    assert list((tmp_path / "spill").rglob("pats.npy"))
    _assert_payloads_equal(spilled.to_arrays(), ram.to_arrays())
    store.save_sweep(spilled)
    assert [kind for _, kind, _, _ in store.entries()] == ["sweeps"]
    hyd = store.load_sweep(trace, spilled.key, device="cpu")
    _assert_payloads_equal(hyd.to_arrays(), ram.to_arrays())
    a, b = store.spill_dir(), store.spill_dir()
    assert a != b and a.parent == b.parent == tmp_path / "spill"


def test_reference_store_never_serves_the_port(tmp_path):
    """Both packages' stores on one root: each package's sweep of the same
    trace and configuration lands under its own name, and neither is the
    other's hit."""
    trace = np.asarray(get_trace("gradle", 3_000, seed=0), np.uint64)
    kw = dict(cache_size=500, update_interval=150)
    ref_store, store = RefArtifactStore(tmp_path), ArtifactStore(tmp_path)
    ref_st = RefSystemTrace.compute(RefSimulator(RefSimConfig(**kw)), trace)
    ref_store.save_sweep(ref_st)
    key = SystemTrace.system_key(SimConfig(**kw))
    assert repr(key) == repr(ref_st.key)       # the same system-key text
    digest = store.trace_digest(trace)
    assert digest == ref_store.trace_digest(trace)
    assert not store.has_sweep(digest, key)
    assert store.load_sweep(trace, key, device="cpu") is None
    st = SystemTrace.compute(Simulator(SimConfig(**kw), "cpu"), trace)
    store.save_sweep(st)
    assert len(list((tmp_path / "sweeps").glob("*.npz"))) == 2
    # the reverse: the port's entry is not the reference's hit
    ref_only = RefArtifactStore(tmp_path / "ref")
    port_only = ArtifactStore(tmp_path / "ref")
    port_only.save_sweep(st)
    assert ref_only.load_sweep(trace, ref_st.key) is None
    assert not ref_only.has_sweep(digest, ref_st.key)
    assert store.sweep_meta(digest, key).startswith("torch-v")
    assert store.sweep_meta(digest, key) != \
        ref_store.sweep_meta(digest, ref_st.key)
    tkey = ("exhaustive", False, (1.0, 2.0, 3.0), 100.0)
    for dev in ("cpu", "cuda"):
        assert store.table_meta(digest, key, dev, tkey) != \
            ref_store.table_meta(digest, ref_st.key, tkey)


def test_card_table_is_never_a_cpu_hit(tmp_path):
    """Tables are keyed on the device type they were built on: an entry
    written under the ``cuda`` key is a miss for a CPU run (and a CPU
    table is written under ``cpu``)."""
    store = ArtifactStore(tmp_path)
    digest, key = "a" * 64, (3,)
    tkey = ("ds_pgm", False, (1.0, 2.0, 3.0), 100.0)
    card_meta = store.table_meta(digest, key, "cuda", tkey)
    assert card_meta != store.table_meta(digest, key, "cpu", tkey)
    assert "|cuda|" in card_meta
    store._write(store._path("table", card_meta),
                 {"table": np.arange(8, dtype=np.int64)}, card_meta)
    assert store.load_table(digest, key, tkey, "cpu") is None
    store.save_table(digest, key, tkey, torch.arange(8) * 3)
    got = store.load_table(digest, key, tkey, "cpu")
    assert torch.equal(got, torch.arange(8) * 3)
    assert store.stats["table_hits"] == 1 and \
        store.stats["table_misses"] == 1


def test_corrupt_entry_reads_as_miss_and_rebuilds(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = np.asarray(get_trace("gradle", 2_000, seed=0), np.uint64)
    st = SystemTrace.compute(Simulator(SimConfig(), "cpu"), trace)
    store.save_sweep(st)
    [entry] = list((tmp_path / "sweeps").glob("*.npz"))
    entry.write_bytes(entry.read_bytes()[:100])
    assert store.load_sweep(trace, st.key, device="cpu") is None
    assert store.stats["corrupt_dropped"] == 1 and not entry.exists()
    store.save_sweep(st)
    assert store.load_sweep(trace, st.key, device="cpu") is not None


@pytest.fixture(scope="module")
def golden_store(tmp_path_factory):
    return ArtifactStore(tmp_path_factory.mktemp("golden-store"))


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_golden_scenario_warm_from_store(name, golden_store):
    """Cold then warm on each golden sub-grid: the warm run computes no
    sweep and returns the cold run's records exactly."""
    sc = get_scenario(name)
    cold = run_scenario(sc, golden=True, store=golden_store, device="cpu")
    before = systemstate.SWEEPS_COMPUTED
    warm = run_scenario(sc, golden=True, store=golden_store, device="cpu")
    assert systemstate.SWEEPS_COMPUTED == before, name
    assert warm == cold, name


def _tool(root, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.store_tool", "--store",
         str(root), *args], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120)


def test_store_tool_ls_verify_gc(tmp_path):
    store = ArtifactStore(tmp_path)
    store.save_table("a" * 64, (3,), ("k1",), np.arange(8))
    store.save_table("b" * 64, (3,), ("k2",), np.arange(8))
    ls = _tool(tmp_path, "ls")
    assert ls.returncode == 0 and "total: 2 entries" in ls.stdout
    ver = _tool(tmp_path, "verify")
    assert ver.returncode == 0 and "0 corrupt" in ver.stdout
    gc = _tool(tmp_path, "gc", "--max-bytes", "1K")
    assert gc.returncode == 0 and len(store.entries()) < 2
    [(path, _, _, _)] = store.entries()
    path.write_bytes(b"not an archive")
    bad = _tool(tmp_path, "verify")
    assert bad.returncode == 1 and "CORRUPT" in bad.stdout


def test_store_tool_rejects_bad_size_as_usage_error(tmp_path):
    proc = _tool(tmp_path, "gc", "--max-bytes", "lots")
    assert proc.returncode == 2 and "invalid size" in proc.stderr
