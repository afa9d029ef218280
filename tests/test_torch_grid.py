"""The port's grid layer on the CPU — sweeps, scenarios and the spawn
pool — against the committed golden results and the JAX reference.

  * every golden file (all 15, the two topology ones and the file-backed
    ``trace_file_smoke`` included) reproduced BIT FOR BIT by the port's own
    scenario registry, traces and grid runner (``scenario_grid``, the grid
    step of ``run_scenario``), every raw accumulator of every cell;
  * ``run_scenario``'s flat records equal to the reference's
    ``run_scenario`` records, scenario for scenario;
  * the port's scenario registry equal to the reference's, field for field;
  * sweep sharing: the same ``SWEEPS_COMPUTED`` deltas as the reference
    (one sweep per trace on a decision-side axis), results equal to
    independent runs;
  * ``workers=2`` bit-identical to ``workers=0``, its sweeps computed in
    the pool and hydrated by the parent;
  * a ``mesh`` that is not a ``DeviceMesh`` raises (the sharded grid:
    ``tests/test_torch_mesh_grid.py``).
"""
import dataclasses
import json
from pathlib import Path

import pytest

import repro.cachesim.systemstate as ref_systemstate
import repro_torch.cachesim.systemstate as systemstate
from repro.cachesim import SimConfig as RefSimConfig
from repro.cachesim import get_scenario as ref_get_scenario
from repro.cachesim import run_grid as ref_run_grid
from repro.cachesim import run_scenario as ref_run_scenario
from repro.cachesim import run_sweep as ref_run_sweep
from repro.cachesim.scenarios import GOLDEN_SCENARIOS as REF_GOLDEN
from repro.cachesim.scenarios import SCENARIOS as REF_SCENARIOS
from repro_torch.cachesim import (GOLDEN_SCENARIOS, SCENARIOS, ArtifactStore,
                                  SimConfig, get_scenario, get_trace,
                                  run_cells, run_grid, run_scenario,
                                  run_sweep, scenario_grid, sweep_records)
from repro_torch.cachesim.sweep import (axis_column, cell_label,
                                        hashable_label)

GOLDEN_DIR = Path(__file__).parent / "golden"


def _assert_cell(res, cell: dict, ctx: str):
    """Every field of the result dataclass (``SimResult`` or
    ``TopoResult``) equals the committed JSON, none dropped."""
    fields = tuple(f.name for f in dataclasses.fields(res))
    assert set(cell["result"]) == set(fields), ctx
    for f in fields:
        got = getattr(res, f)
        if isinstance(got, tuple):
            got = list(got)
        assert got == cell["result"][f], (ctx, f, got, cell["result"][f])


def _assert_grids_identical(a, b):
    assert set(a) == set(b)
    for key, cell in a.items():
        assert set(cell) == set(b[key]), key
        for p, res in cell.items():
            assert dataclasses.asdict(res) == dataclasses.asdict(b[key][p]), \
                (key, p)
            assert (res.advert_events, res.advert_bytes) == \
                (b[key][p].advert_events, b[key][p].advert_bytes), (key, p)


def test_golden_set_is_all_fifteen_files():
    on_disk = {p.stem for p in GOLDEN_DIR.glob("*.json")}
    assert set(GOLDEN_SCENARIOS) == on_disk
    assert len(GOLDEN_SCENARIOS) == 15
    assert GOLDEN_SCENARIOS == REF_GOLDEN


def test_scenario_registry_equals_reference():
    """All 20 scenarios, field for field (traces, axes, values, bases,
    golden sub-grids, topologies)."""
    assert list(SCENARIOS) == list(REF_SCENARIOS)
    assert len(SCENARIOS) == 20
    for name, sc in SCENARIOS.items():
        assert dataclasses.asdict(sc) == \
            dataclasses.asdict(REF_SCENARIOS[name]), name


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_port_scenarios_match_golden(name):
    """The port's own scenario, traces (``tests/data`` parsed by the port's
    loader for ``trace_file_smoke``) and grid runner reproduce every
    committed cell bit for bit."""
    payload = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    sc = get_scenario(name)
    assert payload["axis"] == sc.axis
    assert payload["n_requests"] == sc.golden_n_requests
    grid, _ = scenario_grid(sc, golden=True, device="cpu")
    seen = set()
    for cell in payload["cells"]:
        key = (cell["trace"], hashable_label(cell["label"]))
        _assert_cell(grid[key][cell["policy"]], cell,
                     f"{name}/{key}/{cell['policy']}")
        seen.add(key + (cell["policy"],))
    assert seen == {k + (p,) for k in grid for p in sc.policies}


@pytest.mark.parametrize("name", GOLDEN_SCENARIOS)
def test_run_scenario_records_equal_reference(name):
    """``run_scenario``'s flat records (rounded summaries, advert totals,
    coupled overrides) equal the reference's, record for record."""
    got = run_scenario(get_scenario(name), golden=True, device="cpu")
    want = ref_run_scenario(ref_get_scenario(name), golden=True)
    assert got == want


@pytest.mark.parametrize("name", ["topo_path", "topo_tree"])
def test_topology_golden_reference_engine_spot_check(name):
    """The first golden cell of each topology scenario through the port's
    recording reference loop (``engine="reference"``)."""
    payload = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    sc = get_scenario(name)
    traces, values = sc.golden_grid()
    first = payload["cells"][0]
    value = next(v for v in values if cell_label(sc.axis, v) ==
                 hashable_label(first["label"]))
    grid = run_grid({first["trace"]: traces[first["trace"]]},
                    sc.config(engine="reference", **sc.golden_base),
                    sc.axis, [value], policies=sc.policies,
                    share_system=False, device="cpu")
    out = grid[(first["trace"], cell_label(sc.axis, value))]
    for cell in payload["cells"]:
        if cell["trace"] == first["trace"] and \
                cell["label"] == first["label"]:
            _assert_cell(out[cell["policy"]], cell,
                         f"{name}/{cell['policy']} (reference loop)")


def test_decision_axis_shares_one_sweep_per_trace():
    """fig3_penalty_shared (4 traces x 8 miss-penalty cells): one sweep per
    trace, as in the reference (same ``SWEEPS_COMPUTED`` delta), results
    equal to independent per-cell runs and to the reference's grid."""
    sc = get_scenario("fig3_penalty_shared")
    traces = sc.make_traces(4_000)
    before = systemstate.SWEEPS_COMPUTED
    shared = run_grid(traces, sc.config(), sc.axis, sc.values,
                      policies=sc.policies, device="cpu")
    port_delta = systemstate.SWEEPS_COMPUTED - before
    ref_sc = ref_get_scenario("fig3_penalty_shared")
    before = ref_systemstate.SWEEPS_COMPUTED
    want = ref_run_grid(traces, ref_sc.config(), ref_sc.axis, ref_sc.values,
                        policies=ref_sc.policies)
    assert port_delta == ref_systemstate.SWEEPS_COMPUTED - before == \
        len(traces) == 4
    indep = run_grid(traces, sc.config(), sc.axis, sc.values,
                     policies=sc.policies, share_system=False, device="cpu")
    _assert_grids_identical(shared, indep)
    assert set(shared) == set(want)
    for key, cell in shared.items():
        for p, res in cell.items():
            assert dataclasses.asdict(res) == \
                dataclasses.asdict(want[key][p]), (key, p)


def test_system_axis_grid_and_records_equal_reference():
    """A system-side axis (one sweep per cell), per-cache tuple cells, and
    the flattened records."""
    traces = {"gradle": get_trace("gradle", 4_000, seed=2),
              "wiki": get_trace("wiki", 4_000, seed=2)}
    values = (100, (50, 150, 600))
    kw = dict(cache_size=800)
    before = systemstate.SWEEPS_COMPUTED
    got = run_grid(traces, SimConfig(**kw), "update_interval", values,
                   policies=("fna", "fna_cal", "fno", "pi"), device="cpu")
    assert systemstate.SWEEPS_COMPUTED - before == 4
    want = ref_run_grid(traces, RefSimConfig(**kw), "update_interval",
                        values, policies=("fna", "fna_cal", "fno", "pi"))
    assert list(got) == list(want)
    for key, cell in got.items():
        for p, res in cell.items():
            assert dataclasses.asdict(res) == \
                dataclasses.asdict(want[key][p]), (key, p)
    from repro.cachesim import sweep_records as ref_sweep_records
    assert sweep_records(got) == ref_sweep_records(want)


def test_run_sweep_equals_reference():
    traces = {"scarab": get_trace("scarab", 3_000, seed=4)}
    got = run_sweep(traces, SimConfig(cache_size=600), (64, 256),
                    policies=("fna", "fno"), device="cpu")
    want = ref_run_sweep(traces, RefSimConfig(cache_size=600), (64, 256),
                         policies=("fna", "fno"))
    for key, cell in got.items():
        for p, res in cell.items():
            assert dataclasses.asdict(res) == \
                dataclasses.asdict(want[key][p]), (key, p)


def test_axis_column_and_duplicate_cells():
    assert axis_column("update_interval") == "update_interval"
    assert axis_column("hit_ratio") == "axis_hit_ratio"
    assert axis_column("trace") == "axis_trace"
    traces = {"gradle": get_trace("gradle", 500, seed=0)}
    with pytest.raises(ValueError, match="duplicate grid cell"):
        run_grid(traces, SimConfig(), "update_interval", (100, 100),
                 policies=("pi",), device="cpu")


def _small_grid(**kw):
    traces = {"gradle": get_trace("gradle", 4_000, seed=0)}
    return run_grid(traces, SimConfig(), "update_interval", (100, 400),
                    policies=("fna", "fno", "pi"), device="cpu", **kw)


def test_workers_bit_identical_to_serial(tmp_path):
    """Two system-key groups farmed to a two-process spawn pool: the
    parent computes no sweep (it hydrates both from the store) and the
    grid equals the serial one bit for bit."""
    serial = _small_grid()
    store = ArtifactStore(tmp_path)
    before = systemstate.SWEEPS_COMPUTED
    parallel = _small_grid(store=store, workers=2)
    assert systemstate.SWEEPS_COMPUTED == before
    assert store.stats["sweep_hits"] == 2
    _assert_grids_identical(parallel, serial)


def test_workers_without_store_use_a_call_scoped_root():
    _assert_grids_identical(_small_grid(workers=2), _small_grid())


def test_mesh_other_than_none_raises():
    """A ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError``; None
    on a single process runs unsharded."""
    trace = get_trace("gradle", 200, seed=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_grid({"gradle": trace}, SimConfig(), "update_interval", (100,),
                 device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_cells(trace, [SimConfig()], ("fna",), device="cpu",
                  mesh=object())
    out = run_grid({"gradle": trace}, SimConfig(), "update_interval", (100,),
                   policies=("fna",), device="cpu", mesh=None)
    assert out[("gradle", 100)]["fna"].n_requests == 200
