"""The port's simulator slice as a whole, on the CPU, against the JAX
reference and its committed golden results.

  * every flat golden file (``tests/golden/*.json`` except the topology
    ones) reproduced BIT FOR BIT by the port's fast engine, all policies,
    with configs and traces taken from the reference's scenario registry
    (the port has no scenario layer yet); cells of a decision-side axis
    share one sweep through the port's ``run_cells``, exactly as the
    reference's grid runner groups them;
  * one golden cell per scenario through the port's reference loop;
  * the JAX fast engine and the port on one direct case (gradle, 20k
    requests, n = 5, both subroutines, four policies): identical results;
  * the port's phase-1 ``to_arrays()`` equals the reference's, and the
    port's phases 2-3 replayed on the reference's own phase-1 payload
    (``SystemTrace.from_reference_arrays``) equal the reference's replay;
  * the calibrated policy's exhaustive speculation tables go through the
    subset-DP entry point, and a ``RunReport`` records a run's phases
    without changing its results.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.cachesim import SimConfig as RefSimConfig
from repro.cachesim import Simulator as RefSimulator
from repro.cachesim import get_scenario
from repro.cachesim import run_policies as ref_run_policies
from repro.cachesim.scenarios import GOLDEN_SCENARIOS
from repro.cachesim.sweep import cell_label, cell_overrides, hashable_label
from repro.cachesim.systemstate import SystemTrace as RefSystemTrace
from repro_torch.cachesim import (RunReport, SimConfig, SimResult,
                                  Simulator, SystemTrace, get_trace,
                                  run_cells, run_policies)
from repro_torch.kernels.subsetdp import ref as subsetdp_ref

GOLDEN_DIR = Path(__file__).parent / "golden"
FLAT_GOLDEN = tuple(n for n in GOLDEN_SCENARIOS
                    if n not in ("topo_path", "topo_tree"))
RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(SimResult))
POLICIES = ("fna", "fno", "pi", "fna_cal")


def _port_cfg(ref_cfg) -> SimConfig:
    """The port's SimConfig with every field of a reference one."""
    return SimConfig(**dataclasses.asdict(ref_cfg))


def _golden_cells(name):
    """(scenario, payload, [(trace name, trace, label, ref cfg)])."""
    sc = get_scenario(name)
    payload = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    traces, values = sc.golden_grid()
    base = sc.config(engine="fast", **sc.golden_base)
    cells = [(t, traces[t], cell_label(sc.axis, v),
              dataclasses.replace(base, **cell_overrides(sc.axis, v)))
             for t in traces for v in values]
    return sc, payload, cells


def _assert_golden(res, cell, ctx):
    assert set(cell["result"]) == set(RESULT_FIELDS), ctx
    for f in RESULT_FIELDS:
        assert getattr(res, f) == cell["result"][f], (ctx, f)


def test_flat_golden_set_is_thirteen_files():
    on_disk = {p.stem for p in GOLDEN_DIR.glob("*.json")}
    assert set(FLAT_GOLDEN) == on_disk - {"topo_path", "topo_tree"}
    assert len(FLAT_GOLDEN) == 13


@pytest.mark.parametrize("name", FLAT_GOLDEN)
def test_port_fast_engine_matches_golden(name):
    """Every committed (trace, cell, policy) result of a flat golden
    scenario, reproduced by the port's fast engine bit for bit."""
    sc, payload, cells = _golden_cells(name)
    assert payload["n_requests"] == sc.golden_n_requests
    results = {}
    for tname in dict.fromkeys(t for t, *_ in cells):
        groups = {}                 # one shared sweep per system key
        for t, trace, label, ref_cfg in cells:
            if t == tname:
                cfg = _port_cfg(ref_cfg)
                groups.setdefault(SystemTrace.system_key(cfg), []).append(
                    (label, trace, cfg))
        for group in groups.values():
            out = run_cells(group[0][1], [cfg for *_, cfg in group],
                            sc.policies, device="cpu")
            for (label, *_), cell_res in zip(group, out):
                results[(tname, label)] = cell_res
    seen = set()
    for cell in payload["cells"]:
        key = (cell["trace"], hashable_label(cell["label"]))
        _assert_golden(results[key][cell["policy"]], cell,
                       f"{name}/{key}/{cell['policy']}")
        seen.add(key + (cell["policy"],))
    assert seen == {k + (p,) for k in results for p in sc.policies}


@pytest.mark.parametrize("name", FLAT_GOLDEN)
def test_port_reference_loop_matches_golden(name):
    """The first golden cell of each scenario through the port's
    per-request reference loop."""
    sc, payload, cells = _golden_cells(name)
    first = payload["cells"][0]
    t, trace, label, ref_cfg = next(
        c for c in cells if c[0] == first["trace"] and
        c[2] == hashable_label(first["label"]))
    cfg = dataclasses.replace(_port_cfg(ref_cfg), engine="reference")
    out = run_policies(trace, cfg, sc.policies, device="cpu")
    for cell in payload["cells"]:
        if cell["trace"] == t and hashable_label(cell["label"]) == label:
            _assert_golden(out[cell["policy"]], cell,
                           f"{name}/{cell['policy']} (reference loop)")


def _direct_cfg(alg):
    return dict(n_caches=5, costs=(1.0, 2.0, 3.0, 1.5, 2.5),
                cache_size=1_000, update_interval=200, alg=alg)


def _assert_same(got, want, ctx):
    assert got.to_dict() == want.to_dict(), ctx
    assert dataclasses.asdict(got) == dataclasses.asdict(want), ctx
    assert (got.advert_events, got.advert_bytes) == \
        (want.advert_events, want.advert_bytes), ctx


@pytest.mark.parametrize("alg", ["ds_pgm", "exhaustive"])
def test_port_matches_jax_fast_engine(alg):
    """gradle, 20k requests, n = 5: the JAX package's fast engine and the
    port's give identical results for all four policies."""
    trace = get_trace("gradle", 20_000, seed=0)
    kw = _direct_cfg(alg)
    want = ref_run_policies(trace, RefSimConfig(**kw), policies=POLICIES)
    got = run_policies(trace, SimConfig(**kw), policies=POLICIES,
                       device="cpu")
    for p in POLICIES:
        _assert_same(got[p], want[p], (alg, p))


PHASE1_CFGS = {
    "paper": dict(cache_size=800, update_interval=150),
    "hetero_self_adjusting": dict(
        n_caches=4, costs=(1.0, 2.0, 4.0, 1.5),
        cache_size=(300, 600, 900, 400), update_interval=(60, 120, 240, 90),
        est_interval=(20, 30, 40, 25), advert_policy="self_adjusting",
        advert_bandwidth=4.0, advert_threshold=0.05),
}


def _assert_payloads_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("chunk_size", [None, 777])
@pytest.mark.parametrize("cfg_name", sorted(PHASE1_CFGS))
def test_phase1_to_arrays_equals_reference(cfg_name, chunk_size):
    kw = PHASE1_CFGS[cfg_name]
    trace = get_trace("scarab", 6_000, seed=3)
    want = RefSystemTrace.compute(RefSimulator(RefSimConfig(**kw)),
                                  trace, chunk_size=chunk_size)
    got = SystemTrace.compute(Simulator(SimConfig(**kw), "cpu"), trace,
                              chunk_size=chunk_size)
    _assert_payloads_equal(got.to_arrays(), want.to_arrays())


@pytest.mark.parametrize("alg", ["ds_pgm", "exhaustive"])
def test_replay_on_reference_phase1_equals_reference_replay(alg):
    """The port's phases 2-3 on the reference's own phase-1 payload give
    the reference's results, for every policy."""
    trace = get_trace("gradle", 8_000, seed=5)
    kw = _direct_cfg(alg)
    ref_st = RefSystemTrace.compute(RefSimulator(RefSimConfig(**kw)), trace)
    st = SystemTrace.from_reference_arrays(
        ref_st.to_arrays(), SystemTrace.system_key(SimConfig(**kw)), "cpu",
        trace)
    for p in POLICIES + ("hocs",) if alg == "ds_pgm" else POLICIES:
        pkw = dict(kw, policy=p)
        if p == "hocs":
            pkw["costs"] = (2.0,) * 5
        want = RefSimulator(RefSimConfig(**pkw)).run(trace, system=ref_st)
        got = Simulator(SimConfig(**pkw), "cpu").run(trace, system=st)
        _assert_same(got, want, (alg, p))


def test_fna_cal_exhaustive_tables_go_through_subset_argmin(monkeypatch):
    """fna_cal with the exhaustive subroutine builds its speculation tables
    through ``subset_argmin`` (the kernel on a card, its plain version
    here), and still equals the JAX fast engine."""
    calls = []
    plain = subsetdp_ref.subset_argmin_ref

    def counted(*args, **kw):
        calls.append(args[1].shape[0])
        return plain(*args, **kw)

    monkeypatch.setattr(subsetdp_ref, "subset_argmin_ref", counted)
    trace = get_trace("gradle", 6_000, seed=4)
    kw = dict(_direct_cfg("exhaustive"), policy="fna_cal")
    got = Simulator(SimConfig(**kw), "cpu").run(trace)
    want = RefSimulator(RefSimConfig(**kw)).run(trace)
    assert calls and all(rows % (1 << 5) == 0 for rows in calls)
    _assert_same(got, want, "fna_cal exhaustive")


@pytest.mark.parametrize("share_system", [True, False])
def test_run_report_records_phases_without_changing_results(share_system):
    trace = get_trace("gradle", 5_000, seed=6)
    cfg = SimConfig(**_direct_cfg("exhaustive"))
    report = RunReport()
    got = run_policies(trace, cfg, POLICIES, share_system=share_system,
                       device="cpu", report=report)
    want = run_policies(trace, cfg, POLICIES, share_system=share_system,
                        device="cpu")
    for p in POLICIES:
        _assert_same(got[p], want[p], p)
    assert report.system.trace_len == trace.shape[0]
    assert report.phase1_s > 0.0
    assert set(report.phase2_s) == set(report.phase3_s) == set(POLICIES)
    assert all(s >= 0.0 for s in (*report.phase2_s.values(),
                                  *report.phase3_s.values()))
