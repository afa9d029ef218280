"""The port's host-side copies (``repro_torch.core`` scalar model,
policies, indicators and estimators; ``repro_torch.cachesim`` traces, LRU
and advert decisions) against the JAX package's originals on seeded
inputs.  They are the oracle's own arithmetic, so every comparison is
exact."""
import numpy as np
import pytest

import repro.cachesim.advert as r_adv
import repro.core.estimator as r_est
import repro.core.indicator as r_ind
import repro.core.model as r_model
import repro.core.policies as r_pol
from repro.cachesim import SimConfig as RefSimConfig
from repro.cachesim.lru import LRUCache as RefLRU
from repro.cachesim.traces import get_trace as ref_get_trace
import repro_torch.cachesim.advert as t_adv
import repro_torch.core.estimator as t_est
import repro_torch.core.indicator as t_ind
import repro_torch.core.model as t_model
import repro_torch.core.policies as t_pol
from repro_torch.cachesim import SimConfig
from repro_torch.cachesim.lru import LRUCache
from repro_torch.cachesim.traces import get_trace


def _problems(seed, n, count=60):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        costs = rng.uniform(0.05, 5.0, n).tolist()
        rhos = rng.uniform(0.0, 1.0, n).tolist()
        if rng.random() < 0.3:           # ties: equal costs and rhos
            costs = [costs[0]] * n
            rhos = [rhos[0]] * n
        yield costs, rhos, float(rng.uniform(1.5, 500.0))


@pytest.mark.parametrize("fn", ["ds_pgm", "ds_pgm_mask", "exhaustive",
                                "exhaustive_mask"])
@pytest.mark.parametrize("n", [1, 3, 6])
def test_restricted_subroutines_equal(fn, n):
    for costs, rhos, M in _problems(10 + n, n):
        assert getattr(t_pol, fn)(costs, rhos, M) == \
            getattr(r_pol, fn)(costs, rhos, M)


def test_hocs_and_geometric_equal():
    rng = np.random.default_rng(3)
    for _ in range(300):
        n = int(rng.integers(1, 9))
        nx = int(rng.integers(0, n + 1))
        pi, nu = rng.random(2)
        M = float(rng.uniform(0.5, 800.0))
        assert t_pol.hocs_fna(nx, n, pi, nu, M) == \
            r_pol.hocs_fna(nx, n, pi, nu, M)
        assert t_pol._argmin_geometric(M, pi, n) == \
            r_pol._argmin_geometric(M, pi, n)


def test_model_and_cs_policies_equal():
    rng = np.random.default_rng(4)
    for _ in range(200):
        h, fp, fn, q = rng.random(4)
        assert t_model.exclusion_probabilities(h, fp, fn) == \
            r_model.exclusion_probabilities(h, fp, fn)
        assert t_model.hit_ratio_from_q(q, fp, fn) == \
            r_model.hit_ratio_from_q(q, fp, fn)
    views = [(float(c), *map(float, rng.random(3))) for c in (1.0, 2.0, 3.0)]
    t_views = [t_model.CacheView(*v) for v in views]
    r_views = [r_model.CacheView(*v) for v in views]
    for ind in ([1, 0, 1], [0, 0, 0], [1, 1, 1]):
        assert t_pol.cs_fna(t_views, ind, 90.0) == \
            r_pol.cs_fna(r_views, ind, 90.0)
        assert t_pol.cs_fno(t_views, ind, 90.0) == \
            r_pol.cs_fno(r_views, ind, 90.0)
        assert t_pol.expected_cost(t_views, ind, [0, 2], 90.0) == \
            r_pol.expected_cost(r_views, ind, [0, 2], 90.0)
    assert t_pol.perfect_information([3.0, 1.0, 2.0], [True, False, True]) \
        == r_pol.perfect_information([3.0, 1.0, 2.0], [True, False, True])


def test_indicator_hashing_and_estimates_equal():
    keys = np.random.default_rng(5).integers(0, 2**62, 2000, dtype=np.int64)
    for k, m, seed in ((3, 1000, 0), (10, 14_000, 7)):
        assert np.array_equal(t_ind.hash_indices(keys, k, m, seed),
                              r_ind.hash_indices(keys, k, m, seed))
    t_pair = t_ind.StaleIndicatorPair(5000, 7, seed=3)
    r_pair = r_ind.StaleIndicatorPair(5000, 7, seed=3)
    for i, key in enumerate(keys[:600].tolist()):
        for pair in (t_pair, r_pair):
            pair.cbf.add(key)
            if i % 50 == 0:
                pair.cbf.remove(keys[i // 2])
            if i % 97 == 0:
                pair.advertise()
        assert t_pair.estimate_rates() == r_pair.estimate_rates()
    assert t_ind.optimal_k(14.0) == r_ind.optimal_k(14.0)
    assert t_ind.theoretical_fp(14.0) == r_ind.theoretical_fp(14.0)


def test_estimators_equal():
    rng = np.random.default_rng(6)
    ind = rng.random(1234) < 0.4
    tq, rq = t_est.QEstimator(100, 0.25), r_est.QEstimator(100, 0.25)
    tq.observe_batch(ind[:700])
    rq.observe_batch(ind[:700])
    for x in ind[700:]:
        tq.observe(bool(x))
        rq.observe(bool(x))
    assert (tq.q, tq.version) == (rq.q, rq.version)
    outcomes = (rng.random(300) < 0.5).astype(np.float64)
    assert t_est.ewma_path(0.9, outcomes, 0.05).tobytes() == \
        r_est.ewma_path(0.9, outcomes, 0.05).tobytes()


@pytest.mark.parametrize("name", ["wiki", "gradle", "scarab", "f2"])
def test_traces_equal(name):
    assert np.array_equal(get_trace(name, 30_000, seed=2),
                          ref_get_trace(name, 30_000, seed=2))


def test_unknown_trace_raises():
    with pytest.raises(KeyError):
        get_trace("file:/nonexistent.log", 10)


def test_lru_equal():
    keys = np.random.default_rng(7).integers(0, 300, 3000).tolist()
    t, r = LRUCache(100), RefLRU(100)
    for x in keys:
        assert t.put(x) == r.put(x)
    assert list(t.keys()) == list(r.keys())


def test_advert_decisions_equal():
    kw = dict(n_caches=3, costs=(1.0, 2.0, 3.0), cache_size=(200, 300, 400),
              advert_policy=("periodic", "delta", "self_adjusting"),
              advert_bandwidth=2.0)
    assert t_adv.resolve_advert(SimConfig(**kw)) == \
        r_adv.resolve_advert(RefSimConfig(**kw))
    t_pair = t_ind.StaleIndicatorPair(4000, 6, seed=1)
    r_pair = r_ind.StaleIndicatorPair(4000, 6, seed=1)
    for key in range(0, 900, 3):
        t_pair.cbf.add(key)
        r_pair.cbf.add(key)
    for pol in ("periodic", "delta"):
        assert t_adv.advert_cost(t_pair, pol) == r_adv.advert_cost(r_pair, pol)
    assert t_adv.predicted_fn(t_pair) == r_adv.predicted_fn(r_pair)
    assert t_adv.self_adjusting_decision(t_pair, 1e9, 0.01) == \
        r_adv.self_adjusting_decision(r_pair, 1e9, 0.01)
