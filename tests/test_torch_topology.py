"""The port's hierarchical topologies (``repro_torch.cachesim.topology``)
on the CPU.

  * deep PATH and TREE hierarchies: the fast engine (per-tier sweeps,
    decision plans on the device, selections copied to the host once)
    equals the port's own recording reference loop and the JAX package's
    ``run_topology``, every ``TopoResult`` field and ``to_dict()``;
  * a knob-free depth-1 path IS the flat engine (``run_policies``), on
    both engines, advert totals included;
  * the hand-computed queue / latency / origin case;
  * cross-tier sweep sharing: 3 sweeps for depths (1, 2, 3) with one
    shared pool, 6 without, 0 warm from a store — the reference's deltas;
  * ``topo_cell`` routing and ``TopoConfig`` validation, leaf routing.
"""
import dataclasses

import numpy as np
import pytest

import repro.cachesim.systemstate as ref_systemstate
import repro_torch.cachesim.systemstate as systemstate
from repro.cachesim import SimConfig as RefSimConfig
from repro.cachesim.topology import TopoConfig as RefTopoConfig
from repro.cachesim.topology import edge_assignment as ref_edge_assignment
from repro.cachesim.topology import run_topo_grid as ref_run_topo_grid
from repro.cachesim.topology import run_topology as ref_run_topology
from repro_torch.cachesim import (ArtifactStore, SimConfig, SimResult,
                                  TopoConfig, TopoResult, get_trace, run_grid,
                                  run_policies, run_topo_grid, run_topology)
from repro_torch.cachesim.topology import edge_assignment, topo_cell

SIM_FIELDS = tuple(f.name for f in dataclasses.fields(SimResult))
TIERS = (dict(cache_size=200, tier_latency=1.0, hop_penalty=4.0,
              queue_capacity=30, queue_window=32),
         dict(cache_size=500, update_interval=160, tier_latency=8.0),
         dict(cache_size=900, update_interval=320))


def _panel(out):
    return {p: dataclasses.asdict(r) for p, r in out.items()}


def _topo(cls, sim_cls, engine, kind, **kw):
    return cls(base=sim_cls(engine=engine, update_interval=80), kind=kind,
               tiers=TIERS, origin_penalty=80.0, origin_latency=32.0, **kw)


@pytest.mark.parametrize("kind,kw", (
    ("path", dict(depth=3)),
    ("tree", dict(depth=2, fanout=3)),
    ("tree", dict(depth=3, fanout=2)),
))
def test_deep_fast_matches_reference_loop_and_jax(kind, kw):
    trace = np.asarray(get_trace("gradle", 2_000, seed=5), np.uint64)
    policies = ("fna", "fna_cal", "fno", "pi")
    fast = run_topology(trace, _topo(TopoConfig, SimConfig, "fast", kind,
                                     **kw), policies, device="cpu")
    loop = run_topology(trace, _topo(TopoConfig, SimConfig, "reference",
                                     kind, **kw), policies, device="cpu")
    jax_ref = ref_run_topology(trace, _topo(RefTopoConfig, RefSimConfig,
                                            "fast", kind, **kw), policies)
    assert _panel(fast) == _panel(loop) == _panel(jax_ref)
    for p in policies:
        assert fast[p].to_dict() == jax_ref[p].to_dict()
        assert (fast[p].advert_events, fast[p].advert_bytes) == \
            (loop[p].advert_events, loop[p].advert_bytes) == \
            (jax_ref[p].advert_events, jax_ref[p].advert_bytes)
    assert sum(fast["fna"].tier_arrivals[1:]) > 0


@pytest.mark.parametrize("engine", ("fast", "reference"))
def test_depth1_path_equals_flat_run_policies(engine):
    trace = get_trace("gradle", 2_500, seed=3)
    cfg = SimConfig(engine=engine, cache_size=500, update_interval=120,
                    advert_policy="self_adjusting", advert_bandwidth=0.5,
                    advert_threshold=0.05, advert_check=16)
    policies = ("fna", "fna_cal", "fno", "pi")
    flat = run_policies(trace, cfg, policies, device="cpu")
    topo = run_topology(np.asarray(trace, np.uint64),
                        TopoConfig(base=cfg, kind="path", depth=1),
                        policies, device="cpu")
    for p in policies:
        for f in SIM_FIELDS:
            assert getattr(topo[p], f) == getattr(flat[p], f), (engine, p, f)
        assert (topo[p].advert_events, topo[p].advert_bytes) == \
            (flat[p].advert_events, flat[p].advert_bytes), (engine, p)
        assert topo[p].tier_arrivals == [len(trace)]
        assert topo[p].rejected == 0 and topo[p].total_latency == 0.0
        assert topo[p].origin_fetches == len(trace) - topo[p].hits


@pytest.mark.parametrize("engine", ("fast", "reference"))
def test_hand_computed_queue_latency_origin(engine):
    """Four arrivals of one key through a single queued tier (in_dj =
    F,T,T,T; the 1-per-2 window admits arrivals 0 and 2; ``pi`` probes
    only when resident, so arrival 2 is the single hit)."""
    trace = np.asarray([7, 7, 7, 7], np.uint64)
    cfg = SimConfig(engine=engine, cache_size=1_000)
    topo = TopoConfig(
        base=cfg, kind="path", depth=1,
        tiers=(dict(queue_capacity=1, queue_window=2, tier_latency=2.0),),
        origin_penalty=50.0, origin_latency=5.0)
    res = run_topology(trace, topo, ("pi",), device="cpu")["pi"]
    probe_cost = float(cfg.costs[7 % cfg.n_caches])
    assert isinstance(res, TopoResult)
    assert res.n_requests == 4 and res.tier_arrivals == [4]
    assert res.tier_rejected == [2] and res.rejected == 2
    assert res.tier_hits == [1] and res.hits == 1
    assert res.origin_fetches == 3
    assert res.total_cost == 3 * 50.0 + probe_cost
    assert res.total_latency == 4 * 2.0 + 3 * 5.0
    assert res.pos_accesses + res.neg_accesses == 1
    assert res.mean_latency == res.total_latency / 4
    assert res.rejection_rate == 2 / 4
    for key in ("mean_latency", "rejection_rate", "origin_fetches"):
        assert key in res.to_dict()


def _depth_axis_base(cls=TopoConfig, sim_cls=SimConfig):
    return cls(base=sim_cls(engine="fast", update_interval=100),
               kind="path", depth=3,
               tiers=(dict(cache_size=250), dict(cache_size=600),
                      dict(cache_size=1_100)))


def test_depth_axis_shares_tier_sweeps():
    """Depths (1, 2, 3) with one shared pool: one sweep per distinct tier
    stream (3, as the reference), 6 without sharing; both grids equal
    each other and the reference's."""
    traces = {"gradle": get_trace("gradle", 2_000, seed=7)}
    deltas = []
    grids = []
    for share in (True, False):
        before = systemstate.SWEEPS_COMPUTED
        grids.append(run_topo_grid(traces, _depth_axis_base(), "depth",
                                   (1, 2, 3), policies=("fna", "pi"),
                                   share_system=share, device="cpu"))
        deltas.append(systemstate.SWEEPS_COMPUTED - before)
        before = ref_systemstate.SWEEPS_COMPUTED
        want = ref_run_topo_grid(traces, _depth_axis_base(RefTopoConfig,
                                                          RefSimConfig),
                                 "depth", (1, 2, 3), policies=("fna", "pi"),
                                 share_system=share)
        assert deltas[-1] == ref_systemstate.SWEEPS_COMPUTED - before
        for key in want:
            assert _panel(grids[-1][key]) == _panel(want[key]), key
    assert deltas == [3, 6]
    for key in grids[0]:
        assert _panel(grids[0][key]) == _panel(grids[1][key]), key


def test_topology_store_reuses_tier_sweeps(tmp_path):
    store = ArtifactStore(tmp_path / "store")
    traces = {"gradle": get_trace("gradle", 2_000, seed=7)}
    first = run_topo_grid(traces, _depth_axis_base(), "depth", (1, 2, 3),
                          policies=("fna",), store=store, device="cpu")
    assert store.stats["sweep_misses"] == 3
    before = systemstate.SWEEPS_COMPUTED
    again = run_topo_grid(traces, _depth_axis_base(), "depth", (1, 2, 3),
                          policies=("fna",), store=store, device="cpu")
    assert systemstate.SWEEPS_COMPUTED - before == 0
    assert store.stats["sweep_hits"] >= 3
    for key in first:
        assert _panel(first[key]) == _panel(again[key]), key


def test_run_grid_routes_a_topology_base():
    traces = {"gradle": get_trace("gradle", 1_500, seed=2)}
    got = run_grid(traces, _depth_axis_base(), "depth", (1, 2),
                   policies=("fno",), device="cpu")
    want = run_topo_grid(traces, _depth_axis_base(), "depth", (1, 2),
                         policies=("fno",), device="cpu")
    assert list(got) == [("gradle", 1), ("gradle", 2)]
    for key in got:
        assert isinstance(got[key]["fno"], TopoResult)
        assert _panel(got[key]) == _panel(want[key])


def test_pool_on_another_device_is_refused():
    from repro_torch.cachesim.topology import SweepPool
    pool = SweepPool(device="cpu")
    trace = np.asarray(get_trace("gradle", 100, seed=0), np.uint64)
    with pytest.raises(ValueError, match="sweep pool"):
        run_topology(trace, _depth_axis_base(), ("pi",), pool=pool,
                     device="meta")


def test_topo_cell_routing_and_validation():
    base = _depth_axis_base()
    assert topo_cell(base, {"depth": 2}).depth == 2
    bcast = topo_cell(base, {"hop_penalty": 3.0})
    assert [bcast.tier_spec(d).hop_penalty for d in range(3)] == [3.0] * 3
    per = topo_cell(base, {"tier_latency": (1.0, 2.0, 4.0)})
    assert [per.tier_spec(d).tier_latency for d in range(3)] == \
        [1.0, 2.0, 4.0]
    with pytest.raises(ValueError, match="length"):
        topo_cell(base, {"tier_latency": (1.0, 2.0)})
    sim = topo_cell(base, {"miss_penalty": 64.0})
    assert sim.base.miss_penalty == 64.0
    assert sim.origin_penalty_value() == 64.0
    with pytest.raises(ValueError, match="kind"):
        TopoConfig(base=base.base, kind="ring")
    with pytest.raises(ValueError, match="depth"):
        TopoConfig(base=base.base, depth=0)
    with pytest.raises(ValueError, match="fanout"):
        TopoConfig(base=base.base, kind="tree", fanout=0)
    with pytest.raises(ValueError, match="neither"):
        TopoConfig(base=base.base, tiers=(dict(cache_sz=10),))


def test_leaf_routing_equals_reference():
    trace = np.asarray(get_trace("wiki", 3_000, seed=2), np.uint64)
    for n in (1, 3, 4):
        leaves = edge_assignment(trace, n)
        assert leaves.tobytes() == ref_edge_assignment(trace, n).tobytes()
        assert set(np.unique(leaves)) <= set(range(n))
