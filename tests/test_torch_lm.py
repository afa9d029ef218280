"""The port's LM serving path against the JAX package, on the reduced
smollm-135m (dense GQA transformer) and mamba2-370m (Mamba2/SSD) configs
in float32, with the same JAX-initialised weights on both sides
(``models.convert.params_from_jax``) and the same numpy-seeded tokens.

Checks: ``forward`` logits; ``prefill`` logits and caches; four
``decode_step``s fed the same tokens; the int8-KV (``--kv-quant``)
decode; ``ServeEngine`` greedy tokens (equal); and the serving launcher
without ``--replay``, whose ``[serve]`` statistics (requests, mean cost,
hit ratio, prefills, negative probes) must equal the JAX launcher's —
the router is deterministic host code.  On the CPU the prefill runs the
kernels' plain versions.

Tolerance: 1e-4 (rtol and atol) on logits, caches and states.  Both
sides compute in float32; XLA and ATen sum the matrix products in other
orders (about 1e-6 relative per product) and two layers, a norm and the
tied unembedding compound it.  The int8 caches are compared exactly
where the float values are not within 1e-4 of a rounding boundary.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import main as jax_serve
from repro.models import get_model as jax_model
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.base import PORT_DEFAULTS
from repro_torch.launch.serve import main as port_serve
from repro_torch.models import get_model, make_concrete_batch, params_from_jax
from repro_torch.serving import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["smollm-135m", "mamba2-370m"]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread is ~30x faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch, **over):
    """(cfg, port model, port params, JAX model, JAX params), built once
    per configuration (nothing below mutates the weights)."""
    cfg = get_config(arch).reduced(**over)
    jcfg = jax_config(arch).reduced(**over)
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       **PORT_DEFAULTS}
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, get_model(cfg), params, jm, jparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_configs_equal_jax():
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS
    assert PORT_ARCHS == JAX_ARCHS
    # the JAX package's fields equal, the port's own (B/C groups, the
    # published Zamba2 block's) at their defaults for every one of its archs
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)
                if f.name in PORT_DEFAULTS}
    assert defaults == PORT_DEFAULTS
    for arch in PORT_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == {
            **dataclasses.asdict(jax_config(arch)), **PORT_DEFAULTS}
        assert get_config(arch).param_count() == \
            jax_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_layout(arch):
    cfg, _, params, _, jparams = _setup(arch)
    assert len(params["layers"]) == cfg.n_layers
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    n_port = sum(t.numel() for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n_port == sum(int(np.prod(a.shape)) for _, a in flat) == \
        cfg.param_count()
    batch = make_concrete_batch(cfg, 2, 5, torch.Generator().manual_seed(0),
                                device="cpu")
    assert set(batch) == {"tokens", "labels"}
    assert batch["tokens"].shape == (2, 5)
    assert int(batch["tokens"].max()) < cfg.vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    cfg, model, params, jm, jparams = _setup(arch)
    toks = _tokens(cfg, 2, 40)
    got = model.forward(params, {"tokens": torch.as_tensor(toks).long()})
    want = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    assert got.shape == want.shape == (2, 40, cfg.vocab_padded)
    _close(got, want)


def _prefill_both(cfg, model, params, jm, jparams, toks, max_len):
    batch_p = {"tokens": torch.as_tensor(toks).long()}
    batch_j = {"tokens": jnp.asarray(toks)}
    if cfg.family == "ssm":
        return model.prefill(params, batch_p), jm.prefill(jparams, batch_j)
    return (model.prefill(params, batch_p, max_len=max_len),
            jm.prefill(jparams, batch_j, max_len=max_len))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [24, 40])
def test_prefill_and_decode_match_jax(arch, s):
    """Prefill logits and caches, then four decode steps fed the JAX
    side's greedy tokens, logits and caches compared after each."""
    cfg, model, params, jm, jparams = _setup(arch)
    toks = _tokens(cfg, 2, s, seed=s)
    (lg, cache), (jlg, jcache) = _prefill_both(cfg, model, params, jm,
                                               jparams, toks, s + 6)
    _close(lg, jlg)
    assert set(cache) == set(jcache)
    for name in cache:
        if name == "len":
            assert cache["len"] == int(jcache["len"]) == s
        else:
            assert tuple(cache[name].shape) == jcache[name].shape
            _close(cache[name], jcache[name])
    for _ in range(4):
        tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab], -1).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.as_tensor(tok).long())
        jlg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        _close(lg, jlg)
    for name in cache:
        if name != "len":
            _close(cache[name], jcache[name])
        else:
            assert cache["len"] == int(jcache["len"]) == s + 4


def test_kv_quant_decode_matches_jax():
    """int8 KV caches: prefill quantisation and the quantised decode."""
    cfg, model, params, jm, jparams = _setup("smollm-135m", kv_quant=True)
    toks = _tokens(cfg, 2, 24, seed=3)
    (lg, cache), (jlg, jcache) = _prefill_both(cfg, model, params, jm,
                                               jparams, toks, 32)
    _close(lg, jlg)
    assert cache["k"].dtype == torch.int8 and cache["k_s"].dtype == \
        torch.float32
    for name in ("k", "v"):
        diff = np.abs(cache[name].numpy().astype(np.int16) -
                      np.asarray(jcache[name]).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        _close(cache[name + "_s"], jcache[name + "_s"])
    for _ in range(4):
        tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab], -1).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.as_tensor(tok).long())
        jlg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        _close(lg, jlg, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_equal(arch):
    cfg, _, params, _, jparams = _setup(arch)
    toks = _tokens(cfg, 2, 20, seed=5)
    eng = ServeEngine(cfg, params=params, device="cpu")
    jeng = JaxEngine(jax_config(arch).reduced(), params=jparams)
    lg, cache = eng.prefill(toks, max_len=30)
    jlg, jcache = jeng.prefill(toks, max_len=30)
    _close(lg, jlg)
    first = np.argmax(np.asarray(jlg)[:, :cfg.vocab], -1).astype(np.int32)
    before = {k: v.clone() for k, v in cache.items()
              if isinstance(v, torch.Tensor)}
    out, _ = eng.decode(cache, first, 6)
    jout, _ = jeng.decode(jcache, jnp.asarray(first), 6)
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out, jout)
    for k, v in before.items():          # the caller's cache is untouched
        assert torch.equal(cache[k], v), k
    sampled, _ = eng.decode(cache, first, 3, temperature=0.8,
                            generator=torch.Generator().manual_seed(1))
    assert sampled.shape == (2, 3)
    assert ((sampled >= 0) & (sampled < cfg.vocab)).all()


def _serve_stats(text: str) -> dict:
    last = [ln for ln in text.splitlines() if "policy=" in ln][-1]
    keys = ("requests", "mean-cost", "hit", "prefills", "neg_probes")
    return {k: re.search(rf"\b{k}=([0-9.]+)", last).group(1) for k in keys}


@pytest.mark.parametrize("arch,extra", [("smollm-135m", []),
                                        ("smollm-135m", ["--kv-quant"]),
                                        ("mamba2-370m", [])])
def test_serve_launcher_matches_jax(arch, extra, capsys):
    argv = ["--arch", arch, "--requests", "200"] + extra
    assert port_serve(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_serve(argv) == 0
    ref = capsys.readouterr().out
    stats = _serve_stats(port)
    assert stats == _serve_stats(ref)
    assert int(stats["requests"]) == 200 and float(stats["hit"]) > 0
    progress = [ln for ln in port.splitlines() if "reqs" in ln]
    assert progress == [ln for ln in ref.splitlines() if "reqs" in ln]


def test_serve_launcher_reduced_flag():
    """``--no-reduced`` reaches the published config (the JAX launcher's
    ``store_true`` with ``default=True`` could never turn it off)."""
    import argparse
    import repro_torch.launch.serve as launcher
    seen = {}

    def fake_model(args):
        seen["reduced"] = args.reduced
        return 0

    orig = launcher._run_model
    launcher._run_model = fake_model
    try:
        launcher.main(["--no-reduced"])
        assert seen["reduced"] is False
        launcher.main([])
        assert seen["reduced"] is True
    finally:
        launcher._run_model = orig
    assert argparse.BooleanOptionalAction
