"""Concurrent-client replay harness for the FNA serving router (the port of
the JAX package's ``repro.serving.replay``; host code, like the router).

The simulator proved the *policy*; this proves the *implementation*: N
replay clients drive a live :class:`~repro_torch.serving.prefix_cache.
PrefixServeCluster` and the harness records what an operator would page
on — sustained throughput and the p50/p99 DECISION latency (the wall
clock spent inside ``cluster.request``: indicator lookups, Algorithm 2
cache selection, probes, placement — the paper technique on the request
path, excluding any model prefill/decode compute).

Regimes
-------
``REGIMES`` mirrors the cachesim scenario registry's router-relevant
system shapes at serving-tier sizes, so the serving benches exercise the
same heterogeneity the golden simulator scenarios pin:

  * ``hetero_tiers``      — cheap-small through expensive-large nodes
    (scenario ``hetero_tiers``: costs (1, 2, 4), tiered capacities);
  * ``staggered_adverts`` — equal nodes whose advertisement cadences
    span 32..512 insertions (scenario ``staggered_adverts``), so the
    router faces per-node staleness levels;
  * ``delayed_view``      — one node advertises ~an order of magnitude
    less often than its peers (scenario ``delayed_view``): the FN-heavy
    regime where false-negative awareness pays.

Modes
-----
``mode="sequential"`` interleaves the clients' streams round-robin in
``batch_size`` slices on one thread — fully DETERMINISTIC for a fixed
seed (costs, hits, probe counts), the mode tests pin.  ``mode="threads"``
runs one thread per client with a router lock (the router is one
stateful event loop, as in a real front-end); arrival interleaving is
then scheduler-dependent, so only aggregate stats and latency
percentiles are meaningful.  ``rate`` optionally paces each client to a
target AGGREGATE arrival rate (reqs/s) open-loop; the achieved rate is
reported alongside.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.cachesim.traces import recency_trace
from repro_torch.serving.prefix_cache import ClusterConfig, PrefixServeCluster

#: scenario-defined router regimes (see module docstring)
REGIMES: Dict[str, ClusterConfig] = {
    "hetero_tiers": ClusterConfig(
        n_nodes=3, probe_costs=(1.0, 2.0, 4.0),
        node_capacity=(64, 192, 512), update_interval=256,
        miss_penalty=100.0),
    "staggered_adverts": ClusterConfig(
        n_nodes=3, probe_costs=(1.0, 1.5, 2.0),
        node_capacity=192, update_interval=(32, 128, 512),
        miss_penalty=100.0),
    "delayed_view": ClusterConfig(
        n_nodes=3, probe_costs=(1.0, 1.5, 2.0),
        node_capacity=192, update_interval=(48, 48, 640),
        miss_penalty=100.0),
}


def regime_config(name: str, policy: str = "fna") -> ClusterConfig:
    """A fresh ClusterConfig for one named regime + router policy."""
    if name not in REGIMES:
        raise KeyError(f"unknown replay regime {name!r}; "
                       f"known: {sorted(REGIMES)}")
    return dataclasses.replace(REGIMES[name], policy=policy)


@dataclass
class ReplayReport:
    """One replay run's operator-facing summary."""
    regime: str
    policy: str
    n_clients: int
    batch_size: int
    requests: int
    wall_s: float
    achieved_rps: float        # requests / wall (measured, not target)
    target_rps: Optional[float]
    p50_us: float              # decision latency percentiles over all
    p99_us: float              # requests (time inside cluster.request)
    mean_cost: float
    hit_ratio: float
    stats: dict                # RouteStats.to_dict()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["wall_s"] = round(self.wall_s, 4)
        d["achieved_rps"] = round(self.achieved_rps, 1)
        d["p50_us"] = round(self.p50_us, 2)
        d["p99_us"] = round(self.p99_us, 2)
        d["mean_cost"] = round(self.mean_cost, 4)
        d["hit_ratio"] = round(self.hit_ratio, 4)
        return d


def client_streams(n_requests: int, n_clients: int, seed: int = 0,
                   p_new: float = 0.15, window: int = 96) -> List[np.ndarray]:
    """One recency-biased prefix stream per client (deterministic per
    seed); clients share a key space, so popular prefixes collide across
    clients exactly like shared system prompts do."""
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
    per = n_requests // n_clients
    return [recency_trace(per, p_new=p_new, window=window,
                          seed=seed * 1000 + c + 1)
            for c in range(n_clients)]


def _percentiles(lat_s: Sequence[float]):
    arr = np.asarray(lat_s, dtype=np.float64) * 1e6
    if arr.shape[0] == 0:
        return 0.0, 0.0
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 99)))


def replay(regime: Union[str, ClusterConfig], policy: str = "fna",
           n_requests: int = 4_000, n_clients: int = 4, batch_size: int = 1,
           mode: str = "threads", rate: Optional[float] = None,
           seed: int = 0,
           make_kv: Callable[[], object] = lambda: True) -> ReplayReport:
    """Replay ``n_requests`` across ``n_clients`` concurrent clients
    against one cluster; returns the :class:`ReplayReport`.

    ``regime`` is a ``REGIMES`` name or an explicit ``ClusterConfig``
    (whose policy is then overridden by ``policy``).  ``batch_size`` is
    the number of requests a client issues back-to-back per turn while
    holding the router.  ``make_kv`` builds the KV payload on a miss —
    the default stub keeps the harness model-free, so the latency rows
    isolate the ROUTING path."""
    if isinstance(regime, str):
        cfg = regime_config(regime, policy)
        regime_name = regime
    else:
        cfg = dataclasses.replace(regime, policy=policy)
        regime_name = "custom"
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if mode not in ("sequential", "threads"):
        raise ValueError(f"unknown replay mode {mode!r}")
    cluster = PrefixServeCluster(cfg, seed=seed)
    streams = client_streams(n_requests, n_clients, seed=seed)
    lat: List[float] = []
    perf = time.perf_counter

    t0 = perf()
    if mode == "sequential":
        cursors = [0] * n_clients
        live = True
        while live:
            live = False
            for c, stream in enumerate(streams):
                i = cursors[c]
                stop = min(i + batch_size, stream.shape[0])
                for k in range(i, stop):
                    t1 = perf()
                    cluster.request(int(stream[k]), make_kv=make_kv)
                    lat.append(perf() - t1)
                cursors[c] = stop
                live = live or stop < stream.shape[0]
    else:
        lock = threading.Lock()
        lat_lock = threading.Lock()
        # open-loop pacing: each client owns every n_clients-th slot of
        # the aggregate arrival schedule
        interval = (n_clients / rate) if rate else None

        def run_client(c: int, stream: np.ndarray) -> None:
            local: List[float] = []
            n = stream.shape[0]
            i = 0
            while i < n:
                if interval is not None:
                    due = t0 + (i // batch_size) * batch_size * interval \
                        + c * interval / n_clients
                    delay = due - perf()
                    if delay > 0:
                        time.sleep(delay)
                stop = min(i + batch_size, n)
                with lock:
                    # latency measured INSIDE the router lock: the
                    # decision path itself, not queueing delay
                    for k in range(i, stop):
                        t1 = perf()
                        cluster.request(int(stream[k]), make_kv=make_kv)
                        local.append(perf() - t1)
                i = stop
            with lat_lock:
                lat.extend(local)

        threads = [threading.Thread(target=run_client, args=(c, s))
                   for c, s in enumerate(streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = perf() - t0

    s = cluster.stats
    p50, p99 = _percentiles(lat)
    return ReplayReport(
        regime=regime_name, policy=cfg.policy, n_clients=n_clients,
        batch_size=batch_size, requests=s.requests, wall_s=wall,
        achieved_rps=s.requests / wall if wall > 0 else 0.0,
        target_rps=rate, p50_us=p50, p99_us=p99,
        mean_cost=s.mean_cost, hit_ratio=s.hit_ratio,
        stats=s.to_dict())


def batch_sweep(regime: str, policy: str = "fna",
                batch_sizes: Sequence[int] = (1, 4, 16),
                n_requests: int = 4_000, n_clients: int = 4,
                mode: str = "threads", seed: int = 0) -> List[ReplayReport]:
    """One replay per batch size (fresh cluster each), same total load —
    how much router-turn amortisation buys under contention."""
    return [replay(regime, policy=policy, n_requests=n_requests,
                   n_clients=n_clients, batch_size=b, mode=mode, seed=seed)
            for b in batch_sizes]
