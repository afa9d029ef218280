"""Traffic: the request stream and the documents, made from a traffic file's
parameters and the run's seed.

A mix is a closed loop of one client: it sends the next request when the
last has returned.  Each request names a document (a prefix of
``prefix_len`` token ids) and asks for ``n_out`` greedy tokens after it.
Which document each request names follows the generator the file names;
the one generator so far is ``recency``: a Gradle-like stream in which a
new document arrives with probability ``p_new`` and otherwise a recent one
comes back, at a Zipf(``alpha``) distance into the last ``window``
requests (a frozen copy of the program's ``cachesim.traces.recency_trace``,
kept here so that the yardstick cannot move).

The stream (which requests repeat which document) is drawn from the
file's ``trace_seed`` and the router's hash seeds from its
``router_seed``, the same in every run, so that every seed routes alike
and serves the same amount of work (which requests hit and which
prefill); the run's seed draws the documents' tokens, and the harness
draws the weights from it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _zipf_cdf(window: int, alpha: float) -> np.ndarray:
    w = np.arange(1, window + 1, dtype=np.float64) ** -alpha
    return np.cumsum(w) / w.sum()


def recency_trace(n: int, p_new: float, window: int, alpha: float,
                  seed: int) -> np.ndarray:
    """Document ids of ``n`` requests: new ids with probability ``p_new``,
    else the id ``d`` requests back, d ~ Zipf(alpha) on 1..window (the
    first ``window`` ids are a seeded history)."""
    rng = np.random.default_rng(seed)
    cdf = _zipf_cdf(window, alpha)
    us = rng.random(n)
    ds = np.searchsorted(cdf, rng.random(n)) + 1
    is_new = us < p_new
    out = np.where(is_new, window + np.cumsum(is_new), 0)
    ptr = np.arange(n, dtype=np.int64) - ds
    seed_ref = ~is_new & (ptr < 0)
    out[seed_ref] = window + ptr[seed_ref] + 1
    resolved = is_new | seed_ref
    unres = np.flatnonzero(~resolved)
    while unres.size:
        tgt = ptr[unres]
        done = resolved[tgt]
        out[unres[done]] = out[tgt[done]]
        resolved[unres[done]] = True
        rest = unres[~done]
        ptr[rest] = ptr[ptr[rest]]
        unres = rest
    return out.astype(np.int64)


GENERATORS = {"recency": recency_trace}


def stream(traffic: Dict) -> np.ndarray:
    """The document labels of the mix's requests, set-up's first, then
    the window's."""
    st = dict(traffic["stream"])
    gen = GENERATORS[st.pop("generator")]
    n, trace_seed = st.pop("requests"), st.pop("trace_seed")
    st.pop("router_seed")
    return gen(n, seed=trace_seed, **st)


class Documents:
    """Token ids [1, prefix_len] of each label, drawn from (seed, label)
    and kept once drawn."""

    def __init__(self, seed: int, vocab: int, length: int):
        self.seed, self.vocab, self.length = int(seed) % (1 << 63), vocab, \
            length
        self._docs: Dict[int, np.ndarray] = {}

    def __call__(self, label: int) -> np.ndarray:
        doc = self._docs.get(label)
        if doc is None:
            rng = np.random.default_rng([self.seed, int(label)])
            doc = rng.integers(0, self.vocab, (1, self.length),
                               dtype=np.int64).astype(np.int32)
            self._docs[label] = doc
        return doc
