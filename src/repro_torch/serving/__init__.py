"""The prefix-cache routing tier (host code): the FNA router, its cluster
and the replay harness.  The JAX package's ``ServeEngine`` belongs to the
LM stack and is not ported yet."""
from repro_torch.serving.prefix_cache import (
    ClusterConfig,
    FNARouter,
    PrefixCacheNode,
    PrefixServeCluster,
    RouteStats,
)
from repro_torch.serving.replay import (
    REGIMES,
    ReplayReport,
    batch_sweep,
    client_streams,
    regime_config,
    replay,
)

__all__ = ["PrefixCacheNode", "FNARouter", "PrefixServeCluster",
           "ClusterConfig", "RouteStats", "REGIMES", "ReplayReport",
           "batch_sweep", "client_streams", "regime_config", "replay"]
