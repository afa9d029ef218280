"""Trace-driven multi-cache simulation (paper Sec. V) on a torch device.

The port of the JAX package's ``repro.cachesim``: the per-request
reference loop and the shared-SystemTrace fast engine — a
policy-independent system sweep (``systemstate``, host NumPy) feeding
per-policy decision plans (``engine``; tables on the device, the
exhaustive ones through the hand-written subset-DP kernel) and the
replay (``fastpath``; device gathers, host cost fold).  On top of it the
grid layer: policy x trace x axis grids that share one sweep per system
configuration (``sweep``), the named experiment configurations and their
golden sub-grids (``scenarios``), the content-addressed artifact store
(``store``), file-backed traces (``tracefiles``) and PATH/TREE
hierarchies of tier nodes (``topology``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the reference's device mesh is
not ported (one card, ``mesh=None``).
"""
from repro_torch.cachesim.engine import (
    DecisionPlan,
    PROVIDERS,
    RunReport,
    TablePlan,
    plan_for,
    prefetch_tables,
    register_provider,
    run_cells,
)
from repro_torch.cachesim.lru import LRUCache
from repro_torch.cachesim.scenarios import (
    GOLDEN_SCENARIOS,
    SCENARIOS,
    Scenario,
    get_scenario,
    list_scenarios,
    run_scenario,
    scenario_grid,
)
from repro_torch.cachesim.simulator import (
    SimConfig,
    SimResult,
    Simulator,
    run_policies,
)
from repro_torch.cachesim.store import ArtifactStore
from repro_torch.cachesim.sweep import run_grid, run_sweep, sweep_records
from repro_torch.cachesim.systemstate import SystemTrace
from repro_torch.cachesim.topology import (
    TierSpec,
    TierSystem,
    TopoConfig,
    TopoResult,
    run_topo_grid,
    run_topology,
)
from repro_torch.cachesim.tracefiles import (
    TraceInfo,
    load_trace_file,
    register_trace_file,
    trace_info,
)
from repro_torch.cachesim.traces import TRACES, get_trace

__all__ = ["ArtifactStore",
           "LRUCache", "SimConfig", "SimResult", "Simulator", "SystemTrace",
           "Scenario", "SCENARIOS", "GOLDEN_SCENARIOS", "get_scenario",
           "list_scenarios", "run_scenario", "run_policies", "run_grid",
           "run_sweep", "sweep_records", "get_trace", "TRACES",
           "TraceInfo", "load_trace_file", "register_trace_file",
           "trace_info",
           "DecisionPlan", "TablePlan", "PROVIDERS", "plan_for",
           "register_provider", "run_cells",
           "TierSpec", "TierSystem", "TopoConfig", "TopoResult",
           "run_topology", "run_topo_grid",
           "RunReport", "prefetch_tables", "scenario_grid"]
