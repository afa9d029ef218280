"""The port's router tier against the JAX package, on the CPU.

  * batched router math (``repro_torch.core.batched``: ``exclusions``,
    ``hit_from_q``, ``rho_matrix``) against ``repro.core.batched`` at
    float32 (JAX's default, x64 off) and at float64 (inside
    ``jax.enable_x64()``).  Tolerance: 2 ulps in the working dtype — the
    same operation chain, where a compiler may still contract a
    multiply-add into one rounding;
  * ``cs_fna_batched``/``cs_fno_batched`` masks EQUAL to JAX's at both
    dtypes, on seeded inputs that include float32 rows with rho = 1
    exactly (h = 0; the clip's ``1 - 1e-12`` rounds to 1.0 in float32, so
    such a cache sorts first) and exact cost ties; and equal to the
    port's scalar ``cs_fna``/``cs_fno``;
  * the host prefix-cache router: a sequential ``replay`` on the port and
    on ``repro.serving`` gives equal ``RouteStats`` field for field and
    equal per-request selections, on every ``REGIMES`` entry and policy;
  * ``python -m repro_torch.launch.serve --replay`` end to end.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batched as rb
import repro.serving as rs
import repro.serving.prefix_cache as rs_prefix
from repro.serving.replay import client_streams as ref_client_streams
import repro_torch.core.batched as tb
import repro_torch.serving as ts
import repro_torch.serving.prefix_cache as ts_prefix
from repro_torch.core import CacheView, cs_fna, cs_fno, ds_pgm

DTYPES = {"float32": np.float32, "float64": np.float64}


def _x64(dtype):
    """JAX's dtype context: x64 off for float32 (JAX's default), on for
    float64."""
    return jax.enable_x64(dtype == np.float64)


def _router_inputs(dtype, n=6, b=3000, seed=0, rho_one=True):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(1, 3, n)
    costs[1] = costs[0]                  # exact cost ties
    costs[4] = costs[3]
    q = rng.uniform(0.1, 0.9, n)
    fp = rng.uniform(0.001, 0.2, n)
    fn = rng.uniform(0.0, 0.45, n)
    if rho_one:
        q[2] = fp[2]                     # h = 0: pi = nu = 1 exactly
        q[5] = 0.5 * fp[5]               # q < fp: h clips to 0
    ind = (rng.random((b, n)) < 0.4).astype(np.int8)
    ind[:8] = 0                          # all-negative and all-positive rows
    ind[8:16] = 1
    return tuple(a.astype(dtype) for a in (costs, q, fp, fn)) + (ind,)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exclusions_and_hit_from_q_match_reference(dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    h = rng.uniform(0.0, 1.0, 512).astype(dt)
    fp = rng.uniform(0.0, 0.3, 512).astype(dt)
    fn = rng.uniform(0.0, 0.5, 512).astype(dt)
    q = rng.uniform(0.0, 1.0, 512).astype(dt)
    h[:3], fp[:3], fn[:3] = 0.0, 0.0, 0.0            # q = 0 and h = 0 edges
    fp[3], fn[3] = 0.5, 0.5                          # denom = 0
    with _x64(dt):
        pi_j, nu_j = (np.asarray(x) for x in rb.exclusions(
            jnp.asarray(h), jnp.asarray(fp), jnp.asarray(fn)))
        hq_j = _jax(rb.hit_from_q, q, fp, fn)
    pi_t, nu_t = tb.exclusions(*(torch.as_tensor(a) for a in (h, fp, fn)))
    hq_t = tb.hit_from_q(*(torch.as_tensor(a) for a in (q, fp, fn)))
    for want, got in ((pi_j, pi_t), (nu_j, nu_t), (hq_j, hq_t)):
        assert got.dtype == getattr(torch, dtype) and want.dtype == dt
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rho_matrix_matches_reference(dtype):
    dt = DTYPES[dtype]
    costs, q, fp, fn, ind = _router_inputs(dt)
    with _x64(dt):
        want = _jax(rb.rho_matrix, ind, q, fp, fn)
    got = tb.rho_matrix(torch.as_tensor(ind), torch.as_tensor(q),
                        torch.as_tensor(fp), torch.as_tensor(fn))
    assert got.dtype == getattr(torch, dtype) and want.dtype == dt
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    assert (want == 1.0).any()           # the rho = 1 rows are there


@pytest.mark.parametrize("policy", ["cs_fna_batched", "cs_fno_batched"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cs_batched_masks_match_reference(dtype, policy):
    dt = DTYPES[dtype]
    for seed in range(3):
        costs, q, fp, fn, ind = _router_inputs(dt, seed=seed)
        with _x64(dt):
            want = _jax(getattr(rb, policy), ind, costs, q, fp, fn, 100.0)
        got = getattr(tb, policy)(
            torch.as_tensor(ind), torch.as_tensor(costs), torch.as_tensor(q),
            torch.as_tensor(fp), torch.as_tensor(fn), 100.0)
        assert got.dtype == torch.bool and got.shape == ind.shape
        np.testing.assert_array_equal(got.numpy(), want)
        if policy == "cs_fno_batched":
            assert not (got.numpy() & (ind == 0)).any()


def test_float32_rho_one_sorts_first_as_in_reference():
    """A cache with rho = 1 (h = 0) has key c / -log(1) = -inf at float32
    and so heads the DS_PGM order; float64 keeps it last.  The float32
    selection therefore probes it on the way to the useful cache, as the
    reference's does, and the float64 one does not."""
    costs = np.array([1.0, 2.0], np.float32)
    rhos = np.array([[0.3, 1.0]], np.float32)
    got32 = tb.ds_pgm_batched(torch.as_tensor(costs), torch.as_tensor(rhos),
                              100.0)
    got64 = tb.ds_pgm_batched(torch.as_tensor(costs, dtype=torch.float64),
                              torch.as_tensor(rhos, dtype=torch.float64),
                              100.0)
    want32 = np.asarray(rb.ds_pgm_batched(jnp.asarray(costs),
                                          jnp.asarray(rhos), 100.0))
    np.testing.assert_array_equal(got32.numpy(), want32)
    assert got32.tolist() == [[True, True]]
    assert got64.tolist() == [[True, False]]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cs_batched_masks_match_scalar_policies(dtype):
    """As tests/test_batched_core.py does for the reference: each batched
    row equals the scalar Algorithm 2 / CS_FNO selection (inputs without
    rho = 1 caches, where float32 and the scalar float64 order agree)."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    n, b = 5, 64
    costs = rng.uniform(1, 3, n)
    q = rng.uniform(0.1, 0.9, n)
    fp = rng.uniform(0.001, 0.2, n)
    fn = rng.uniform(0.0, 0.45, n)
    ind = (rng.random((b, n)) < 0.4).astype(np.int32)
    args = [torch.as_tensor(a.astype(dt)) for a in (costs, q, fp, fn)]
    m_fna = tb.cs_fna_batched(torch.as_tensor(ind), *args, 100.0).numpy()
    m_fno = tb.cs_fno_batched(torch.as_tensor(ind), *args, 100.0).numpy()
    views = [CacheView(cost=costs[j], fp=fp[j], fn=fn[j], q=q[j])
             for j in range(n)]
    for i in range(b):
        assert np.flatnonzero(m_fna[i]).tolist() == \
            cs_fna(views, list(ind[i]), 100.0, alg=ds_pgm)
        assert np.flatnonzero(m_fno[i]).tolist() == \
            cs_fno(views, list(ind[i]), 100.0, alg=ds_pgm)


def test_router_math_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    costs, q, fp, fn, ind = _router_inputs(np.float64, b=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.cs_fna_batched(ind, costs, q, fp, fn, 100.0)
    got = tb.cs_fna_batched(ind, costs, q, fp, fn, 100.0, device="cpu")
    assert got.device.type == "cpu"


def _recorder(monkeypatch, module):
    """Record (prefix, selection, realised cost) of every routed request
    of ``module``'s ``FNARouter``."""
    log = []
    route = module.FNARouter.route

    def recording(self, prefix_hash):
        out = route(self, prefix_hash)
        log.append((prefix_hash, list(out[2]), out[1]))
        return out

    monkeypatch.setattr(module.FNARouter, "route", recording)
    return log


@pytest.mark.parametrize("policy", ["fna", "fno", "fna_cal", "pi"])
@pytest.mark.parametrize("regime", sorted(rs.REGIMES))
def test_sequential_replay_equals_reference(monkeypatch, regime, policy):
    want_log = _recorder(monkeypatch, rs_prefix)
    got_log = _recorder(monkeypatch, ts_prefix)
    kw = dict(policy=policy, n_requests=2_000, n_clients=4, batch_size=2,
              mode="sequential", seed=0)
    want = rs.replay(regime, **kw)
    got = ts.replay(regime, **kw)
    assert len(got_log) == 2_000 and got_log == want_log
    assert got.stats == want.stats
    for field in ("regime", "policy", "n_clients", "batch_size", "requests",
                  "mean_cost", "hit_ratio"):
        assert getattr(got, field) == getattr(want, field), field


def _resident_misses(cluster, keys) -> int:
    """Route ``keys`` through ``cluster``; returns a plain recount of the
    misses whose key the designated node (``key % n_nodes``) held before
    the request."""
    n, count = len(cluster.nodes), 0
    for key in keys:
        held = int(key) in cluster.nodes[int(key) % n].lru
        prefills = cluster.stats.prefills
        cluster.request(int(key))
        count += held and cluster.stats.prefills > prefills
    return count


@pytest.mark.parametrize("regime", sorted(rs.REGIMES))
def test_cluster_route_stats_equal_field_for_field(regime):
    """Driving the clusters directly: every ``RouteStats`` field of the
    reference (the unrounded float sums included) and the per-node
    estimates agree; the port's own ``resident_misses`` equals a plain
    recount."""
    cfg_r = rs.regime_config(regime, "fna")
    cfg_t = ts.regime_config(regime, "fna")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_r)
    want = rs.PrefixServeCluster(cfg_r, seed=3)
    got = ts.PrefixServeCluster(cfg_t, seed=3)
    (stream,) = ts.client_streams(1_500, 1, seed=3)
    np.testing.assert_array_equal(
        stream, ref_client_streams(1_500, 1, seed=3)[0])
    for key in stream:
        want.request(int(key))
    resident = _resident_misses(got, stream)
    got_stats = dataclasses.asdict(got.stats)
    assert got_stats.pop("resident_misses") == resident
    assert got_stats == dataclasses.asdict(want.stats)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.ind.fp_est, a.ind.fn_est) == (b.ind.fp_est, b.ind.fn_est)
        assert list(a.lru.keys()) == list(b.lru.keys())


def test_resident_misses_equal_a_recount_over_the_docqa_stream():
    """The benchmark's docqa stream (4 nodes of 64 prefixes, ``fna_cal``):
    ``RouteStats.resident_misses`` is the plain recount, and most misses
    prefill a document its designated node already held."""
    from repro_torch.cachesim.traces import recency_trace
    mix = json.loads((Path(__file__).resolve().parents[1] /
                      "bench/traffic/docqa.json").read_text())
    st = mix["stream"]
    labels = recency_trace(1_900, p_new=st["p_new"], window=st["window"],
                           alpha=st["alpha"], seed=st["trace_seed"])
    cluster = ts.PrefixServeCluster(ts.ClusterConfig(**mix["cluster"]),
                                    seed=st["router_seed"])
    resident = _resident_misses(cluster, labels)
    assert cluster.stats.resident_misses == resident
    assert resident > cluster.stats.prefills // 2


def test_serve_main_replay_argv(tmp_path, capsys):
    """The --replay launcher path end to end, including the JSON report,
    with the reference's flags and output lines."""
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main
    argv = ["--replay", "--mode", "sequential", "--regime", "delayed_view",
            "--requests", "300", "--clients", "3", "--batch-sizes", "1,2"]
    assert main(argv + ["--json", str(tmp_path / "port.json")]) == 0
    port_out = capsys.readouterr().out
    assert ref_main(argv + ["--json", str(tmp_path / "ref.json")]) == 0
    ref_out = capsys.readouterr().out
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert [r["batch_size"] for r in got] == [1, 2]
    assert all(r["regime"] == "delayed_view" for r in got)
    timing = ("wall_s", "achieved_rps", "p50_us", "p99_us")
    strip = [{k: v for k, v in r.items() if k not in timing} for r in got]
    assert strip == [{k: v for k, v in r.items() if k not in timing}
                     for r in want]

    def untimed(text):
        return [" ".join(w for w in line.split()
                         if not w.startswith(("rps=", "p50=", "p99=")))
                for line in text.splitlines()
                if line.startswith("[replay] regime=")]
    assert untimed(port_out) == untimed(ref_out) and len(untimed(port_out)) == 2


def test_serve_main_without_replay_exits_nonzero(monkeypatch):
    """Without ``--replay`` the launcher runs the model path, on ``cuda``
    unless ``--device cpu`` is given: with no GPU visible it refuses
    (a raised error, so the process exits nonzero) instead of carrying on
    on the CPU."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--requests", "10"])
