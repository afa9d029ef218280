"""The port's moe, vlm, hybrid and encdec serving paths against the JAX
package, on the reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b (moe),
internvl2-1b (vlm), zamba2-7b (hybrid) and seamless-m4t-medium (encdec)
configs, with the same JAX-initialised weights on both sides
(``models.convert.params_from_jax``) and the same numpy-seeded inputs.

Checks: ``forward`` logits; ``prefill`` logits and every cache entry
(for ``vlm`` with a ``max_len`` that covers the patches); four
``decode_step``s fed the same tokens; ``ServeEngine`` greedy tokens
(equal); the serving launcher without ``--replay``, whose ``[serve]``
statistics must equal the JAX launcher's (the router is deterministic
host code); the MoE routing and capacity dispatch (``topi`` and the
dropped (token, choice) set equal to the reference's) with ample
capacity, padded experts and drops; encdec frames of another length than
the tokens; the int8-KV decode of a moe config; bf16 prefills; and the
vlm cache that the JAX launcher sizes too short (ROADMAP C-ref-8).  On
the CPU the prefill runs the kernels' plain versions.

Tolerance: 1e-4 (rtol and atol) in float32, for the reason given in
``tests/test_torch_lm.py``: both sides compute in float32 and XLA and
ATen sum the products in other orders.  MoE stays float32 (in bf16 a
routing near-tie may pick another expert).  bf16 prefills: argmax equal
and logits within ``BF16_LOGIT_SHARE`` of JAX's largest (see there).
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
from repro.models import layers as JL
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import PORT_DEFAULTS
from repro_torch.launch.serve import main as port_serve
from repro_torch.models import get_model, make_concrete_batch, params_from_jax
from repro_torch.models import layers as L
from repro_torch.serving import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
ARCHS = MOE + ["internvl2-1b", "zamba2-7b", "seamless-m4t-medium"]
#: (arch, config overrides) of the forward/prefill/decode checks: each MoE
#: config as ``reduced()`` gives it (``moe_mode`` dense) and in dispatch
CASES = [(a, ()) for a in ARCHS] + [(a, (("moe_mode", "dispatch"),))
                                    for a in MOE]
#: bf16 prefill logits against JAX's, as a share of the largest |logit|
#: of the prompt: measured at most 0.0134 on these inputs (0.0391 absolute
#: in logits up to 3.6: vlm 0.0391/0.0313, hybrid 0.0273/0.0391, encdec
#: 0.0332/0.0313 at S = 24/40), about what the re-anchor found on dense
#: (0.005 in logits up to 0.5).  The two sides round at other places:
#: JAX scales q in bf16 and rounds p to bf16 before PV
#: (``attention_chunked``), the port's flash keeps both in float32, and
#: the bf16 products accumulate in other orders; a bf16 logit near 3 has
#: an ulp of 0.0156.  The bound is 1.5 times the largest share measured.
BF16_LOGIT_SHARE = 0.02


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread is ~30x faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(case):
    arch, over = case
    return arch + "".join(f"-{v}" for _, v in over)


@functools.lru_cache(maxsize=None)
def _setup(arch, over=()):
    """(cfg, port model, port params, JAX model, JAX params), built once
    per configuration (nothing below mutates the weights)."""
    cfg = get_config(arch).reduced(**dict(over))
    jcfg = jax_config(arch).reduced(**dict(over))
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       **PORT_DEFAULTS}
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return cfg, get_model(cfg), params, jm, jparams


def _batch(cfg, b, s, seed=0, s_enc=None):
    """numpy inputs of a prompt of ``s`` tokens: tokens, and the stub
    frontends' ``patch_embeds`` (vlm) or ``frames`` (encdec, ``s_enc``
    long) as standard normals rounded to the compute type."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    extra = {"vlm": ("patch_embeds", cfg.n_patches),
             "encdec": ("frames", s if s_enc is None else s_enc)}
    if cfg.family in extra:
        name, n = extra[cfg.family]
        x = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        out[name] = torch.as_tensor(x).to(L.dtype_of(cfg.dtype)).float() \
            .numpy()
    return out


def _port_batch(cfg, batch):
    cdt = L.dtype_of(cfg.dtype)
    return {k: torch.as_tensor(v).long() if k == "tokens"
            else torch.as_tensor(v).to(cdt) for k, v in batch.items()}


def _jax_batch(cfg, batch):
    cdt = JL.dtype_of(cfg.dtype)
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, cdt)
            for k, v in batch.items()}


def _close(got, want, **tol):
    got = got.float() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


def _prompt_len(cfg, s):
    return s + cfg.n_patches if cfg.family == "vlm" else s


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_layout(arch):
    cfg, model, params, _, jparams = _setup(arch)
    stacks = {"layers": cfg.n_layers, "shared": cfg.n_shared,
              "enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}
    for name, n in stacks.items():
        if name in jparams:
            assert isinstance(params[name], list) and len(params[name]) == n
    n_port = sum(t.numel() for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert n_port == n_jax
    # the port's own random weights have the JAX tree's names and shapes
    own = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda t: tuple(t.shape), params)
    batch = make_concrete_batch(cfg, 2, 40, torch.Generator().manual_seed(0),
                                device="cpu")
    s_text = 40 - cfg.n_patches if cfg.family == "vlm" else 40
    assert batch["tokens"].shape == batch["labels"].shape == (2, s_text)
    if cfg.family == "vlm":
        assert batch["patch_embeds"].shape == (2, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        assert batch["frames"].shape == (2, 40, cfg.d_model)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_logits_match_jax(case):
    cfg, model, params, jm, jparams = _setup(*case)
    batch = _batch(cfg, 2, 32)
    got = model.forward(params, _port_batch(cfg, batch))
    want = jm.forward(jparams, _jax_batch(cfg, batch))
    assert got.shape == want.shape == (2, _prompt_len(cfg, 32),
                                       cfg.vocab_padded)
    _close(got, want)


def _prefill_both(cfg, model, params, jm, jparams, batch, max_len):
    return (model.prefill(params, _port_batch(cfg, batch), max_len=max_len),
            jm.prefill(jparams, _jax_batch(cfg, batch), max_len=max_len))


def _check_cache(cache, jcache, length):
    assert set(cache) == set(jcache)
    for name in cache:
        if name == "len":
            assert cache["len"] == int(jcache["len"]) == length
        else:
            assert tuple(cache[name].shape) == jcache[name].shape, name
            _close(cache[name], jcache[name])


def _decode_both(cfg, model, params, jm, jparams, lg, cache, jlg, jcache,
                 steps=4):
    for _ in range(steps):
        tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab], -1).astype(np.int32)
        lg, cache = model.decode_step(params, cache,
                                      torch.as_tensor(tok).long())
        jlg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        _close(lg, jlg)
    return lg, cache, jlg, jcache


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("s", [24, 40])
def test_prefill_and_decode_match_jax(case, s):
    """Prefill logits and every cache entry, then four decode steps fed
    the JAX side's greedy tokens, logits and caches compared after each.
    The vlm ``max_len`` covers the patches (see
    ``test_vlm_cache_covers_patches``)."""
    cfg, model, params, jm, jparams = _setup(*case)
    n = _prompt_len(cfg, s)
    batch = _batch(cfg, 2, s, seed=s)
    (lg, cache), (jlg, jcache) = _prefill_both(cfg, model, params, jm,
                                               jparams, batch, n + 6)
    _close(lg, jlg)
    _check_cache(cache, jcache, n)
    _, cache, _, jcache = _decode_both(cfg, model, params, jm, jparams, lg,
                                       cache, jlg, jcache)
    _check_cache(cache, jcache, n + 4)


@pytest.mark.parametrize("s_enc", [13, 56])
def test_encdec_frames_of_another_length(s_enc):
    """Frames shorter and longer than the prompt: the cross attention's
    Sq != Sk in the prefill (flash, non-causal) and in decode (the whole
    of ``ck``/``cv``)."""
    cfg, model, params, jm, jparams = _setup("seamless-m4t-medium")
    batch = _batch(cfg, 2, 24, seed=s_enc, s_enc=s_enc)
    (lg, cache), (jlg, jcache) = _prefill_both(cfg, model, params, jm,
                                               jparams, batch, 30)
    assert cache["ck"].shape[2] == s_enc
    _close(lg, jlg)
    _check_cache(cache, jcache, 24)
    _, cache, _, jcache = _decode_both(cfg, model, params, jm, jparams, lg,
                                       cache, jlg, jcache)
    _check_cache(cache, jcache, 28)
    got = model.forward(params, _port_batch(cfg, batch))
    _close(got, jm.forward(jparams, _jax_batch(cfg, batch)))


def test_kv_quant_decode_matches_jax_moe():
    """int8 KV caches of a moe config: prefill quantisation and the
    quantised decode, each layer's FFN through the experts."""
    cfg, model, params, jm, jparams = _setup(
        "granite-moe-3b-a800m", (("kv_quant", True),))
    batch = _batch(cfg, 2, 24, seed=3)
    (lg, cache), (jlg, jcache) = _prefill_both(cfg, model, params, jm,
                                               jparams, batch, 32)
    _close(lg, jlg)
    assert cache["k"].dtype == torch.int8
    for name in ("k", "v"):
        diff = np.abs(cache[name].numpy().astype(np.int16) -
                      np.asarray(jcache[name]).astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        _close(cache[name + "_s"], jcache[name + "_s"])
    for _ in range(4):
        tok = np.argmax(np.asarray(jlg)[:, :cfg.vocab], -1).astype(np.int32)
        lg, cache = model.decode_step(params, cache,
                                      torch.as_tensor(tok).long())
        jlg, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        _close(lg, jlg, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# MoE routing and capacity dispatch
# ---------------------------------------------------------------------------

def _jax_route(p, x, cfg):
    """The reference's routing, as ``repro.models.layers.moe_forward``
    computes it (``layers.py:260-266``)."""
    e = cfg.n_experts_padded
    logits = x.astype(jnp.float32) @ p["router"]
    if e > cfg.n_experts:
        logits = jnp.where(jnp.arange(e) >= cfg.n_experts, -1e30, logits)
    topw, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.topk)
    return topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9), topi


def _jax_kept(ti, cfg):
    """[G,T,K] bools: whether the reference's dispatch keeps each (token,
    choice), read off ``_moe_dispatch_batched`` itself — token rows marked
    t + 1, an identity expert block, one choice's gate at a time."""
    gdim, t, k = ti.shape
    xf = jnp.broadcast_to(jnp.arange(1, t + 1, dtype=jnp.float32)
                          [None, :, None], (gdim, t, 1))
    kept = []
    for j in range(k):
        tw = jnp.zeros((gdim, t, k), jnp.float32).at[..., j].set(1.0)
        out = JL._moe_dispatch_batched(xf, ti, tw, None, cfg,
                                       groups_per_row=1,
                                       expert_fn=lambda xg: xg)
        got = np.asarray(out[..., 0])
        assert set(np.unique(got)) <= {0.0} | set(range(1, t + 1))
        kept.append(got > 0)
    return np.stack(kept, axis=-1)


MOE_DISPATCH = {
    "ample": ("granite-moe-3b-a800m", (("moe_mode", "dispatch"),
                                       ("capacity_factor", 8.0))),
    "padded": ("granite-moe-3b-a800m", (("moe_mode", "dispatch"),
                                        ("expert_pad", 16))),
    "drops": ("qwen3-moe-30b-a3b", (("moe_mode", "dispatch"),
                                    ("capacity_factor", 1.0))),
}


@pytest.mark.parametrize("name", list(MOE_DISPATCH))
def test_moe_dispatch_matches_reference(name):
    """Layer 0's MoE FFN on hidden states of a real prompt: ``topi``
    equal, the dropped (token, choice) set equal, outputs within 1e-4;
    with ample capacity nothing drops and dispatch equals dense, with
    padded experts none of them is chosen (the capacity is counted over
    the padded experts, so choices drop there too), at capacity factor
    1.0 choices drop."""
    arch, over = MOE_DISPATCH[name]
    cfg, model, params, _, jparams = _setup(arch, over)
    p = params["layers"][0]["moe"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    batch = _batch(cfg, 2, 32, seed=11)
    x = np.asarray(jparams["embed"])[batch["tokens"]]
    xt = torch.as_tensor(x)
    topw, topi = L.moe_route(p, xt, cfg)
    jtopw, jtopi = _jax_route(jp, jnp.asarray(x), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    _close(topw, jtopw)
    assert int(topi.max()) < cfg.n_experts
    g = cfg.moe_groups
    ti = topi.reshape(2 * g, 32 // g, cfg.topk)
    cap = L.moe_capacity(32 // g, cfg)
    _, bp = L.dispatch_plan(ti, cfg.n_experts_padded, cap)
    dropped = (bp == cfg.n_experts_padded * cap).reshape(ti.shape).numpy()
    np.testing.assert_array_equal(~dropped,
                                  _jax_kept(jnp.asarray(ti.numpy()), cfg))
    got = L.moe_forward(p, xt, cfg)
    _close(got, JL.moe_forward(jp, jnp.asarray(x), cfg))
    if name == "drops":
        assert dropped.any()
    if name == "ample":
        assert not dropped.any()
        dense = dataclasses.replace(cfg, moe_mode="dense")
        _close(got, L.moe_forward(p, xt, dense))


def test_moe_topk_ties_go_to_the_lower_expert():
    """Exact routing ties (duplicate router columns) pick the lower expert
    index, as ``jax.lax.top_k`` does; the weights are renormalised."""
    cfg = get_config("granite-moe-3b-a800m").reduced(topk=3)
    rng = np.random.default_rng(5)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32)
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    router[:, 6] = router[:, 1]
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    topw, topi = L.moe_route({"router": torch.as_tensor(router)},
                             torch.as_tensor(x), cfg)
    jtopw, jtopi = _jax_route({"router": jnp.asarray(router)},
                              jnp.asarray(x), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    _close(topw, jtopw)
    _close(topw.sum(-1), np.ones((2, 9)))


# ---------------------------------------------------------------------------
# engine, launcher, bf16, the vlm cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_equal(arch):
    cfg, _, params, _, jparams = _setup(arch)
    toks = _batch(cfg, 2, 20, seed=5)["tokens"]
    eng = ServeEngine(cfg, params=params, device="cpu")
    jeng = JaxEngine(jax_config(arch).reduced(), params=jparams)
    lg, cache = eng.prefill(toks, max_len=30)
    jlg, jcache = jeng.prefill(toks, max_len=_prompt_len(cfg, 30))
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


def test_vlm_cache_covers_patches():
    """C-ref-8: the JAX launcher's ``max_len`` (prefix + decode steps + 2)
    does not count internvl2's patches, so the JAX cache is not padded and
    every decode step's write is clamped onto the last prompt slot.  The
    port's engine sizes the cache ``n_patches + max_len``: decoding writes
    each step's K/V at its own position, leaves every prompt slot as the
    prefill wrote it, and equals JAX given a covering ``max_len``."""
    cfg, _, params, _, jparams = _setup("internvl2-1b")
    prefix, steps = 24, 8
    max_len = prefix + steps + 2                # the launchers' max_len
    toks = _batch(cfg, 1, prefix, seed=8)["tokens"]
    eng = ServeEngine(cfg, params=params, device="cpu")
    lg, cache = eng.prefill(toks, max_len=max_len)
    n = cfg.n_patches + prefix
    assert cache["len"] == n
    assert cache["k"].shape[2] == cfg.n_patches + max_len
    first = np.argmax(lg[:, :cfg.vocab].numpy(), -1).astype(np.int32)
    out, after = eng.decode(cache, first, steps)
    for name in ("k", "v"):
        assert torch.equal(after[name][:, :, :n], cache[name][:, :, :n])
        assert bool((after[name][:, :, n:n + steps] != 0).any(-1).any(-1)
                    .all())
    jeng = JaxEngine(jax_config("internvl2-1b").reduced(), params=jparams)
    short = jeng.prefill(toks, max_len=max_len)[1]
    assert short["k"].shape[2] == n            # C-ref-8: no room to decode
    jlg, jcache = jeng.prefill(toks, max_len=cfg.n_patches + max_len)
    _close(lg, jlg)
    jout, jafter = jeng.decode(jcache, jnp.asarray(first), steps)
    np.testing.assert_array_equal(out, jout)
    for name in ("k", "v"):
        _close(after[name], jafter[name])


#: the bf16 prefills held to JAX; dense and ssm guard their argmax against
#: near-ties (ROADMAP C-gap-1 found a mamba2-370m row at S = 40 whose top
#: two JAX logits lie one bf16 ulp apart, 0.38086 and 0.37891)
BF16_ARCHS = ["internvl2-1b", "zamba2-7b", "seamless-m4t-medium",
              "smollm-135m", "mamba2-370m"]
NEAR_TIE_GUARD = {"smollm-135m", "mamba2-370m"}


@pytest.mark.parametrize("arch", BF16_ARCHS)
@pytest.mark.parametrize("s", [24, 40])
def test_bf16_prefill_close_to_jax(arch, s):
    """bf16 activations (float32 weights): the prefill's argmax equal to
    JAX's, its logits within ``BF16_LOGIT_SHARE`` of the largest.  For
    the dense and ssm families the argmax is compared on the rows whose
    top-two JAX logits lie further apart than the measured error (a
    near-tie may go either way); at least one row is compared."""
    cfg, model, params, jm, jparams = _setup(arch, (("dtype", "bfloat16"),))
    batch = _batch(cfg, 2, s, seed=s + 1)
    if cfg.family == "ssm":     # Mamba2LM.prefill takes no max_len
        lg, _ = model.prefill(params, _port_batch(cfg, batch))
        jlg, _ = jm.prefill(jparams, _jax_batch(cfg, batch))
    else:
        (lg, _), (jlg, _) = _prefill_both(cfg, model, params, jm, jparams,
                                          batch, _prompt_len(cfg, s) + 4)
    jlg = np.asarray(jlg)
    assert lg.dtype == torch.float32
    np.testing.assert_allclose(lg.numpy(), jlg, rtol=0,
                               atol=BF16_LOGIT_SHARE * np.abs(jlg).max())
    got, want = lg[:, :cfg.vocab].numpy(), jlg[:, :cfg.vocab]
    rows = np.ones(len(want), bool)
    if arch in NEAR_TIE_GUARD:
        err = np.abs(got - want).max()
        top2 = np.sort(want, -1)[:, -2:]
        rows = top2[:, 1] - top2[:, 0] > err
        assert rows.any()
    np.testing.assert_array_equal(got.argmax(-1)[rows],
                                  want.argmax(-1)[rows])


def _serve_stats(text: str) -> dict:
    last = [ln for ln in text.splitlines() if "policy=" in ln][-1]
    keys = ("requests", "mean-cost", "hit", "prefills", "neg_probes")
    return {k: re.search(rf"\b{k}=([0-9.]+)", last).group(1) for k in keys}


@pytest.mark.parametrize("arch,extra", [(a, []) for a in ARCHS] +
                         [("granite-moe-3b-a800m", ["--kv-quant"])])
def test_serve_launcher_matches_jax(arch, extra, capsys):
    argv = ["--arch", arch, "--requests", "200", "--prefix-len", "16"] + \
        extra
    assert port_serve(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_serve(argv) == 0
    ref = capsys.readouterr().out
    stats = _serve_stats(port)
    assert stats == _serve_stats(ref)
    assert int(stats["requests"]) == 200 and float(stats["hit"]) > 0
    progress = [ln for ln in port.splitlines() if "reqs" in ln]
    assert progress == [ln for ln in ref.splitlines() if "reqs" in ln]
    assert re.search(r"\[serve\] weights arch=\S+ params=\d+ drawn on cpu",
                     port)
