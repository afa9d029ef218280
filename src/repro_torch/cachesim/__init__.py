"""Trace-driven multi-cache simulation (paper Sec. V) on a torch device.

The port of the JAX package's ``repro.cachesim`` flat engine: the
per-request reference loop and the shared-SystemTrace fast engine — a
policy-independent system sweep (``systemstate``, host NumPy) feeding
per-policy decision plans (``engine``; tables on the device, the
exhaustive ones through the hand-written subset-DP kernel) and the
replay (``fastpath``; device gathers, host cost fold).  The grid layer
(sweeps, scenarios, the artifact store, trace files, topologies) is not
ported yet.
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
from repro_torch.cachesim.simulator import (
    SimConfig,
    SimResult,
    Simulator,
    run_policies,
)
from repro_torch.cachesim.systemstate import SystemTrace
from repro_torch.cachesim.traces import TRACES, get_trace

__all__ = ["DecisionPlan", "LRUCache", "PROVIDERS", "RunReport",
           "SimConfig", "SimResult", "Simulator", "SystemTrace", "TRACES",
           "TablePlan", "get_trace", "plan_for", "prefetch_tables",
           "register_provider", "run_cells", "run_policies"]
