"""The serving tier: the prefix-cache router (host code: the FNA router,
its cluster and the replay harness) and the model engine
(``ServeEngine``: prefill and decode on the card)."""
from repro_torch.serving.engine import ServeEngine
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

__all__ = ["ServeEngine", "PrefixCacheNode", "FNARouter", "PrefixServeCluster",
           "ClusterConfig", "RouteStats", "REGIMES", "ReplayReport",
           "batch_sweep", "client_streams", "regime_config", "replay"]
