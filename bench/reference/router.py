"""Plain reference of the prefix-cache router: K nodes, each an LRU of
prefix ids with a counting Bloom filter that it advertises every
``update_interval`` insertions, and a front end that picks the nodes to
probe from the stale bitmaps (paper: "On the Power of False Negative
Awareness in Indicator-based Caching Systems", Algorithm 2 with DS_PGM,
Eqs. 1-3 and 7-9; ``fna_cal`` adds probe-outcome feedback on the
exclusion probabilities).  A miss is prefilled and placed on node
``id % K``.

It replays a request stream and gives, for every request, the nodes
probed (in order) and whether the prefix was found: what the harness
holds the program's router to, request by request.  Written from the
paper and the program's documented behaviour; it imports nothing of the
program.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

M64 = (1 << 64) - 1
EPS = 1e-12


def _mix(z: np.ndarray) -> np.ndarray:
    z = (z + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(M64)
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & \
        np.uint64(M64)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & \
        np.uint64(M64)
    return z ^ (z >> np.uint64(31))


def bits(key: int, k: int, m: int, seed: int) -> np.ndarray:
    """The k bit positions of ``key``: double hashing of two splitmix64
    streams, the first keyed by the filter's seed."""
    x = np.asarray([key], dtype=np.uint64)
    h1 = _mix(x ^ np.uint64(seed * 0x9E3779B97F4A7C15 & M64))
    h2 = _mix(x ^ np.uint64(0xDEADBEEFCAFEBABE)) | np.uint64(1)
    i = np.arange(k, dtype=np.uint64)
    return ((h1[0] + i * h2[0]) % np.uint64(m)).astype(np.int64)


class Node:
    def __init__(self, cap: int, bpe: float, seed: int, adv: int, est: int):
        self.cap, self.adv, self.est = cap, adv, est
        self.lru: "OrderedDict[int, None]" = OrderedDict()
        self.m = max(64, int(bpe * cap))
        self.k = max(1, round(math.log(2.0) * bpe))
        self.seed = seed
        self.counts = np.zeros(self.m, dtype=np.int64)
        self.stale = np.zeros(self.m, dtype=bool)
        self.fp = self.fn = 0.0
        self.since_adv = self.since_est = 0

    def probe(self, key: int) -> bool:
        if key in self.lru:
            self.lru.move_to_end(key)
            return True
        return False

    def rates(self) -> None:
        """Eqs. (7)-(8) from the current and the advertised bitmaps."""
        now = self.counts > 0
        b1 = int(now.sum())
        d1 = int((now & ~self.stale).sum())
        d0 = int((~now & self.stale).sum())
        self.fn = 1.0 - ((b1 - d1) / b1) ** self.k if b1 else 0.0
        self.fp = ((b1 - d1 + d0) / self.m) ** self.k

    def insert(self, key: int) -> None:
        if key in self.lru:
            self.lru.move_to_end(key)
            return
        if len(self.lru) >= self.cap:
            old, _ = self.lru.popitem(last=False)
            b = bits(old, self.k, self.m, self.seed)
            self.counts[b] = np.maximum(self.counts[b] - 1, 0)
        self.lru[key] = None
        self.counts[bits(key, self.k, self.m, self.seed)] += 1
        self.since_adv += 1
        self.since_est += 1
        if self.since_est >= self.est:
            self.rates()
            self.since_est = 0
        if self.since_adv >= self.adv:
            self.stale = self.counts > 0
            self.rates()
            self.since_adv = self.since_est = 0


class QEst:
    """Eq. (9): the positive-indication ratio, updated once an epoch."""

    def __init__(self, horizon: int, delta: float):
        self.horizon, self.delta = horizon, delta
        self.q, self.n, self.pos, self.started = 0.5, 0, 0, False

    def see(self, ind: bool) -> None:
        self.n += 1
        self.pos += int(ind)
        if self.n >= self.horizon:
            frac = self.pos / self.n
            self.q = frac if not self.started else \
                self.delta * frac + (1 - self.delta) * self.q
            self.started, self.n, self.pos = True, 0, 0


def exclusions(q: float, fp: float, fn: float) -> Tuple[float, float]:
    """(pi, nu) of Eqs. (2)-(3), the hit ratio from Eq. (1) inverted."""
    den = 1.0 - fp - fn
    h = min(1.0, max(0.0, q if abs(den) < EPS else (q - fp) / den))
    qq = h * (1 - fn) + (1 - h) * fp
    pi = min(1.0, max(0.0, fp * (1 - h) / qq)) if qq > EPS else 1.0
    nu = min(1.0, max(0.0, (1 - fp) * (1 - h) / (1 - qq))) \
        if 1 - qq > EPS else 0.0
    return pi, nu


def ds_pgm(costs: Sequence[float], rhos: Sequence[float], penalty: float
           ) -> List[int]:
    """The best prefix, under sum(c) + M prod(rho), of the nodes ordered
    by c / -ln(rho)."""
    def key(j):
        return costs[j] / -math.log(min(max(rhos[j], EPS), 1.0 - EPS))
    order = sorted(range(len(costs)), key=key)
    best, best_v, c, r = [], penalty, 0.0, 1.0
    for i, j in enumerate(order):
        c += costs[j]
        r *= rhos[j]
        if c + penalty * r < best_v - EPS:
            best_v, best = c + penalty * r, order[: i + 1]
    return sorted(best)


class Router:
    def __init__(self, cluster: dict, seed: int):
        n = cluster["n_nodes"]
        self.n, self.policy = n, cluster["policy"]
        self.penalty = float(cluster["miss_penalty"])
        self.costs = [1.0 + 0.5 * j for j in range(n)]
        bpe = float(cluster.get("bpe", 14.0))
        self.nodes = [Node(int(cluster["node_capacity"]), bpe, seed * 100 + j,
                           int(cluster["update_interval"]),
                           int(cluster.get("est_interval", 8)))
                      for j in range(n)]
        for nd in self.nodes:
            nd.stale = nd.counts > 0
        self.q = [QEst(50, 0.25) for _ in range(n)]
        self.gamma, self.min_obs, self.eps = 0.05, 20, 0.01
        self.nu_e, self.pi_e = [0.90] * n, [0.5] * n
        self.nu_n, self.pi_n = [0] * n, [0] * n
        self.rng = np.random.default_rng(1234)

    def _select(self, key: int) -> Tuple[List[int], List[bool]]:
        ind = [bool(nd.stale[bits(key, nd.k, nd.m, nd.seed)].all())
               for nd in self.nodes]
        for qe, i in zip(self.q, ind):
            qe.see(i)
        if self.policy == "pi":
            have = [j for j, nd in enumerate(self.nodes) if key in nd.lru]
            return ([min(have, key=lambda j: self.costs[j])] if have else []
                    ), ind
        ex = [exclusions(self.q[j].q, nd.fp, nd.fn)
              for j, nd in enumerate(self.nodes)]
        if self.policy == "fno":
            pos = [j for j in range(self.n) if ind[j]]
            sel = ds_pgm([self.costs[j] for j in pos],
                         [ex[j][0] for j in pos], self.penalty)
            return sorted(pos[i] for i in sel), ind
        rhos = [ex[j][0] if ind[j] else ex[j][1] for j in range(self.n)]
        if self.policy == "fna_cal":
            for j, nd in enumerate(self.nodes):
                blind = nd.fp + nd.fn >= 0.95
                if ind[j] and (self.pi_n[j] >= self.min_obs or blind):
                    rhos[j] = self.pi_e[j]
                elif not ind[j] and (self.nu_n[j] >= self.min_obs or blind):
                    rhos[j] = self.nu_e[j]
        sel = ds_pgm(self.costs, rhos, self.penalty)
        if self.policy == "fna_cal" and self.rng.random() < self.eps:
            j = int(self.rng.integers(0, self.n))
            if j not in sel:
                sel = sorted(sel + [j])
        return sel, ind

    def request(self, key: int) -> Tuple[Tuple[int, ...], bool]:
        """(nodes probed, in order; whether the prefix was found)."""
        sel, ind = self._select(key)
        found = False
        for j in sel:
            here = self.nodes[j].probe(key)
            if self.policy == "fna_cal":
                g = self.gamma
                if ind[j]:
                    self.pi_e[j] = (1 - g) * self.pi_e[j] + g * (not here)
                    self.pi_n[j] += 1
                else:
                    self.nu_e[j] = (1 - g) * self.nu_e[j] + g * (not here)
                    self.nu_n[j] += 1
            found = found or here
        if not found:
            self.nodes[key % self.n].insert(key)
        return tuple(sel), found


def replay(cluster: dict, seed: int, keys) -> List[Tuple[Tuple[int, ...],
                                                         bool]]:
    """Every request's (nodes probed, found) for the stream ``keys``."""
    r = Router(cluster, seed)
    return [r.request(int(k)) for k in keys]
