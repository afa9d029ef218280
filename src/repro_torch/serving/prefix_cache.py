"""Indicator-advertised distributed prefix-KV cache with FNA routing (the
port of the JAX package's ``repro.serving.prefix_cache``).

Host code only.  As in the reference, this router runs NumPy and plain
Python over the port's own ``core`` copies and ``cachesim.lru``: it takes
no ``device`` argument and launches nothing.  Its indications come from
each node's counting Bloom filter with the splitmix64 ``hash_indices``
family (``core/indicator.py``), not from the device Bloom probe
(``kernels/bloom``, murmur-style double hashing), so routing it through
that kernel would change its answers.  The batched device path —
``kernels.bloom.bloom_probe`` then ``core.batched.cs_fna_batched`` /
``cs_fno_batched`` — is a separate entry point over bitmaps built with
``kernels.bloom.build_indicator``.

This is the paper's technique deployed as a first-class serving feature.

Topology: K cache nodes each hold prefill KV caches for prompt *prefixes*
(system prompts, few-shot headers, RAG contexts).  Nodes advertise their
content to the front-end router as Bloom-filter bitmaps — but only every
``update_interval`` insertions, because a fleet-wide indicator push per
insertion would burn the control-plane bandwidth (the paper's premise:
a large CDN's indicators are ~70MB; ours are bpe x capacity bits per node).

Between advertisements the router's replicas go STALE: freshly-prefilled
prefixes look absent (false negatives) and evicted ones look present
(false positives).  The router therefore runs CS_FNA (Algorithm 2):

  * nodes send (FP, FN) estimates from Eqs. (7)-(8) piggybacked on probes,
  * the router keeps per-node EWMA q estimates (Eq. 9),
  * every lookup solves the CS problem over probe costs c_j and the
    prefill-recompute penalty M, possibly probing nodes with NEGATIVE
    indications — which is exactly what recovers the hits that a
    false-negative-oblivious router forfeits.

Costs are in abstract service-cost units (probe RTT ~ 1, prefill of a
P-token prefix ~ M(P)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import tracing
from repro_torch.cachesim.lru import LRUCache
from repro_torch.core import (
    CacheView,
    QEstimator,
    cs_fna,
    cs_fno,
    ds_pgm,
    optimal_k,
    perfect_information,
    rho_vector,
)
from repro_torch.core.indicator import StaleIndicatorPair, hash_indices


def _per_node(value, n: int, cast, name: str) -> tuple:
    """Normalise a scalar-or-sequence node knob to an n-tuple (mirrors
    ``SimConfig._per_cache``): a scalar broadcasts, a sequence must match
    ``n_nodes`` — heterogeneous fleets (tiered capacities, staggered or
    delayed advertisement cadences) set per-node sequences."""
    if isinstance(value, (list, tuple, np.ndarray)):
        vals = tuple(cast(v) for v in value)
        if len(vals) != n:
            raise ValueError(
                f"{name} has {len(vals)} entries for {n} nodes")
        return vals
    return (cast(value),) * n


@dataclass
class ClusterConfig:
    n_nodes: int = 4
    # prefixes per node: scalar, or one value per node (tiered fleets)
    node_capacity: Union[int, Sequence[int]] = 512
    probe_costs: Sequence[float] = ()  # default 1 + j
    miss_penalty: float = 100.0        # prefill recompute in probe-cost units
    bpe: float = 14.0
    # insertions between advertisements: scalar, or per node (staggered /
    # delayed-view regimes)
    update_interval: Union[int, Sequence[int]] = 64
    est_interval: Union[int, Sequence[int]] = 8
    q_horizon: int = 50
    q_delta: float = 0.25
    policy: str = "fna"                # fna | fna_cal | fno | pi
    # fna_cal: empirical exclusion-probability feedback (beyond-paper)
    cal_gamma: float = 0.05
    cal_min_obs: int = 20
    cal_epsilon: float = 0.01

    def __post_init__(self):
        if not self.probe_costs:
            self.probe_costs = tuple(1.0 + j * 0.5 for j in range(self.n_nodes))
        if len(self.probe_costs) != self.n_nodes:
            raise ValueError(
                f"probe_costs has {len(self.probe_costs)} entries for "
                f"{self.n_nodes} nodes")

    @property
    def node_capacities(self) -> tuple:
        return _per_node(self.node_capacity, self.n_nodes, int,
                         "node_capacity")

    @property
    def update_intervals(self) -> tuple:
        return _per_node(self.update_interval, self.n_nodes, int,
                         "update_interval")

    @property
    def est_intervals(self) -> tuple:
        return _per_node(self.est_interval, self.n_nodes, int,
                         "est_interval")


class PrefixCacheNode:
    """One cache node: LRU of prefix -> KV handle + advertised indicator."""

    def __init__(self, capacity: int, bpe: float, seed: int,
                 update_interval: int, est_interval: int):
        self.lru = LRUCache(capacity)
        self.store: Dict[int, object] = {}
        m = max(64, int(bpe * capacity))
        self.ind = StaleIndicatorPair(m, optimal_k(bpe), seed=seed)
        self.update_interval = update_interval
        self.est_interval = est_interval
        self._since_adv = 0
        self._since_est = 0
        self.ind.advertise()

    def lookup(self, prefix_hash: int) -> Optional[object]:
        """The actual probe: returns the KV handle or None."""
        if self.lru.touch(prefix_hash):
            return self.store.get(prefix_hash)
        return None

    def insert(self, prefix_hash: int, kv_handle: object) -> bool:
        """Store ``kv_handle``; returns whether the prefix was new here
        (False: the node already held it, and only the handle changed)."""
        inserted, evicted = self.lru.put(prefix_hash)
        self.store[prefix_hash] = kv_handle
        if not inserted:
            return False
        self.ind.cbf.add(prefix_hash)
        if evicted is not None:
            self.store.pop(evicted, None)
            self.ind.cbf.remove(evicted)
        self._since_adv += 1
        self._since_est += 1
        if self._since_est >= self.est_interval:
            self.ind.estimate_rates()
            self._since_est = 0
        if self._since_adv >= self.update_interval:
            self.ind.advertise()
            self.ind.estimate_rates()
            self._since_adv = 0
            self._since_est = 0
        return True


@dataclass
class RouteStats:
    requests: int = 0
    probes: int = 0
    probe_cost: float = 0.0
    kv_hits: int = 0
    prefills: int = 0
    neg_probes: int = 0
    total_cost: float = 0.0
    # misses whose prefix the designated node already held: each prefill
    # a probe of that node would have saved (the port's own counter; the
    # reference has no such field)
    resident_misses: int = 0

    @property
    def mean_cost(self) -> float:
        return self.total_cost / max(self.requests, 1)

    @property
    def hit_ratio(self) -> float:
        return self.kv_hits / max(self.requests, 1)

    def to_dict(self) -> Dict:
        return {"requests": self.requests, "mean_cost": round(self.mean_cost, 3),
                "hit_ratio": round(self.hit_ratio, 4), "probes": self.probes,
                "neg_probes": self.neg_probes, "prefills": self.prefills}


class FNARouter:
    """Front-end: stale indicator replicas + Algorithm 2 cache selection."""

    def __init__(self, cfg: ClusterConfig, nodes: List[PrefixCacheNode]):
        self.cfg = cfg
        self.nodes = nodes
        self.q_est = [QEstimator(cfg.q_horizon, cfg.q_delta)
                      for _ in range(cfg.n_nodes)]
        self.stats = RouteStats()
        # optimistic init: bootstraps exploration when FP+FN ~ 1 leaves h
        # unidentifiable from (q, FP, FN) — see simulator.py for the rationale
        self._nu_emp = [0.90] * cfg.n_nodes
        self._pi_emp = [0.5] * cfg.n_nodes
        self._nu_obs = [0] * cfg.n_nodes
        self._pi_obs = [0] * cfg.n_nodes
        self._rng = np.random.default_rng(1234)

    def _indications(self, prefix_hash: int) -> List[bool]:
        out = []
        for nd in self.nodes:
            idx = hash_indices(np.asarray([prefix_hash], np.uint64),
                               nd.ind.cbf.k, nd.ind.cbf.m, nd.ind.cbf.seed)[0]
            out.append(bool(nd.ind.stale[idx].all()))
        return out

    def select(self, prefix_hash: int) -> Tuple[List[int], List[bool]]:
        cfg = self.cfg
        indications = self._indications(prefix_hash)
        for qe, ind in zip(self.q_est, indications):
            qe.observe(ind)
        if cfg.policy == "pi":
            contains = [prefix_hash in nd.lru for nd in self.nodes]
            return perfect_information(list(cfg.probe_costs), contains), indications
        views = [CacheView(cost=cfg.probe_costs[j], fp=self.nodes[j].ind.fp_est,
                           fn=self.nodes[j].ind.fn_est, q=self.q_est[j].value)
                 for j in range(cfg.n_nodes)]
        if cfg.policy == "fna_cal":
            model_rho = rho_vector(views, indications)
            rhos = []
            for j in range(cfg.n_nodes):
                uninformative = (self.nodes[j].ind.fp_est +
                                 self.nodes[j].ind.fn_est) >= 0.95
                if indications[j]:
                    use = self._pi_obs[j] >= cfg.cal_min_obs or uninformative
                    rhos.append(self._pi_emp[j] if use else model_rho[j])
                else:
                    use = self._nu_obs[j] >= cfg.cal_min_obs or uninformative
                    rhos.append(self._nu_emp[j] if use else model_rho[j])
            sel = ds_pgm([v.cost for v in views], rhos, cfg.miss_penalty)
            if self._rng.random() < cfg.cal_epsilon:
                jx = int(self._rng.integers(0, cfg.n_nodes))
                if jx not in sel:
                    sel = sorted(sel + [jx])
            return sel, indications
        pol = cs_fna if cfg.policy == "fna" else cs_fno
        return pol(views, indications, cfg.miss_penalty, alg=ds_pgm), indications

    def route(self, prefix_hash: int):
        """Returns (kv_handle or None, realized_cost, selection)."""
        sel, indications = self.select(prefix_hash)
        cost = sum(self.cfg.probe_costs[j] for j in sel)
        self.stats.probes += len(sel)
        self.stats.neg_probes += sum(1 for j in sel if not indications[j])
        self.stats.probe_cost += cost
        kv = None
        g = self.cfg.cal_gamma
        for j in sel:
            found = self.nodes[j].lookup(prefix_hash)
            if self.cfg.policy == "fna_cal":  # probe-outcome feedback
                absent = found is None
                if indications[j]:
                    self._pi_emp[j] = (1 - g) * self._pi_emp[j] + g * absent
                    self._pi_obs[j] += 1
                else:
                    self._nu_emp[j] = (1 - g) * self._nu_emp[j] + g * absent
                    self._nu_obs[j] += 1
            if found is not None and kv is None:
                kv = found
        if kv is None:
            cost += self.cfg.miss_penalty
            self.stats.prefills += 1
        else:
            self.stats.kv_hits += 1
        self.stats.requests += 1
        self.stats.total_cost += cost
        return kv, cost, sel


class PrefixServeCluster:
    """Nodes + router + placement: the complete paper-technique data path."""

    def __init__(self, cfg: ClusterConfig, seed: int = 0):
        self.cfg = cfg
        caps = cfg.node_capacities
        advs, ests = cfg.update_intervals, cfg.est_intervals
        self.nodes = [
            PrefixCacheNode(caps[j], cfg.bpe, seed=seed * 100 + j,
                            update_interval=advs[j],
                            est_interval=ests[j])
            for j in range(cfg.n_nodes)
        ]
        self.router = FNARouter(cfg, self.nodes)

    def request(self, prefix_hash: int, make_kv=lambda: True):
        """Serve one request; on miss, prefill (make_kv) and place the
        result on the designated node."""
        with tracing.span("route", request=self.stats.requests):
            kv, cost, sel = self.router.route(prefix_hash)
            if kv is None:
                kv = make_kv()
                dj = prefix_hash % self.cfg.n_nodes
                if not self.nodes[dj].insert(prefix_hash, kv):
                    self.stats.resident_misses += 1
        return kv, cost

    @property
    def stats(self) -> RouteStats:
        return self.router.stats
