"""The port's training path against the JAX package, on the reduced
configs of the six families in float32 with the same JAX-initialised
weights (``models.convert.params_from_jax`` / ``state_from_jax``) and
the same ``SyntheticLMData`` batches on both sides.

Checks:
  * ``loss`` and every gradient of dense (smollm-135m), moe
    (granite-moe-3b-a800m, ``moe_mode`` dense and dispatch), vlm
    (internvl2-1b), ssm (mamba2-370m), hybrid (zamba2-7b) and encdec
    (seamless-m4t-medium) against ``jax.value_and_grad(model.loss)``,
    with ``remat`` none, full and dots giving the same values;
  * the AdamW update fed the same gradients (a loss linear in the
    parameters, so both sides' gradients are exactly the same numbers)
    against the JAX ``make_train_step``, with and without int8 error
    feedback, including the JAX rank rule of weight decay (C-ref-9);
  * three whole ``make_train_step``s of every family against the JAX jit;
  * ``lr_at``, global-norm clipping and int8 error feedback as
    ``tests/test_data_optim.py`` and ``tests/test_ft.py`` check the JAX
    package's;
  * the SSD's gradient where the JAX ``ssd_chunked``'s is NaN (C-ref-10),
    against the JAX sequential oracle;
  * the kernel guard: ``ssd_scan`` and ``flash_attention`` refuse inputs
    that require a gradient, and the prefills (which call them) run under
    ``torch.no_grad()``.

Tolerances: 1e-4 (rtol and atol) on losses, gradients, grad norms and
learning rates: both sides compute in float32 and XLA and ATen sum the
products in other orders (``tests/test_torch_lm.py``), which the
backward pass compounds.  1e-6 on the AdamW update of identical
gradients: the same float32 arithmetic in the same order, apart from
``pow`` and ``sqrt`` to within an ulp; its global norm, a float32 sum
over every gradient element taken in another order (JAX flattens the
dicts in sorted key order, and XLA and ATen reduce a leaf in other
trees), at 1e-5 relative (measured 2.6e-6 at 279.6).  Parameters after
a whole step: AdamW's first step moves a parameter by lr * g / (|g| +
eps), its sign decided by the gradient, so where a gradient is ~0 noise
decides it; they are compared where the JAX gradient exceeds 1e-3 of its
leaf's largest, to within 1e-5 + 1e-4 * |p|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.distributed import compression as jcomp
from repro.models import get_model as jax_model
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_train_state as j_init_train_state
from repro.optim import lr_at as j_lr_at
from repro.optim import make_train_step as j_make_train_step
from repro.optim.adamw import clip_by_global_norm as j_clip
from repro_torch.configs import get_config
from repro_torch.configs.base import PORT_DEFAULTS
from repro_torch.data import DataConfig, SyntheticLMData, to_device
from repro_torch.distributed import compression as comp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import get_model, params_from_jax, state_from_jax
from repro_torch.optim import (OptConfig, clip_by_global_norm, global_norm,
                               init_train_state, loss_and_grads, lr_at,
                               make_train_step)
from repro_torch.optim.adamw import decays
from repro_torch.tree import tree_leaves, tree_paths

TOL = dict(rtol=1e-4, atol=1e-4)
#: (id, arch, config overrides): one per family, moe in both modes
CASES = [("dense", "smollm-135m", ()),
         ("moe", "granite-moe-3b-a800m", ()),
         ("moe-dispatch", "granite-moe-3b-a800m", (("moe_mode", "dispatch"),)),
         ("vlm", "internvl2-1b", ()),
         ("ssm", "mamba2-370m", ()),
         ("hybrid", "zamba2-7b", ()),
         ("encdec", "seamless-m4t-medium", ())]
IDS = [c[0] for c in CASES]
BATCH, SEQ = 2, 32
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny eager ops: one intra-op thread is ~30x faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(case_id):
    return next(c for c in CASES if c[0] == case_id)


@functools.lru_cache(maxsize=None)
def _setup(case_id):
    """(cfg, JAX model, JAX params as NumPy, data), built once a case."""
    _, arch, over = _case(case_id)
    cfg = get_config(arch).reduced(**dict(over))
    jcfg = jax_config(arch).reduced(**dict(over))
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       **PORT_DEFAULTS}
    jm = jax_model(jcfg)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    data = SyntheticLMData(DataConfig(batch=BATCH, seq=SEQ, vocab=256,
                                      seed=3), model_cfg=cfg)
    return cfg, jm, jparams, data


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(case_id):
    """JAX (loss, tokens, grads in the port's layout) at batch 0."""
    cfg, jm, jparams, data = _setup(case_id)
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(jm.loss, has_aux=True))(
            jparams, _jax_batch(data.batch_at(0)))
    return (float(loss), float(metrics["tokens"]),
            params_from_jax(cfg, jax.tree.map(np.asarray, grads),
                            device="cpu"))


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               err_msg=err_msg, **(tol or TOL))


@functools.lru_cache(maxsize=None)
def _port_loss_grads(case_id, remat):
    cfg, _, jparams, data = _setup(case_id)
    model = get_model(dataclasses.replace(cfg, remat=remat))
    params = params_from_jax(cfg, jparams, device="cpu")
    return loss_and_grads(model, params, to_device(data.batch_at(0), "cpu"))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("case_id", IDS)
def test_loss_and_grads_match_jax(case_id, remat):
    (loss, metrics), grads = _port_loss_grads(case_id, remat)
    jloss, jtokens, jgrads = _jax_loss_grads(case_id)
    _close(loss, jloss)
    assert float(metrics["loss"]) == float(loss)
    assert float(metrics["tokens"]) == jtokens == BATCH * SEQ
    paths = [p for p, _ in tree_paths(jgrads)]
    assert paths == [p for p, _ in tree_paths(grads)]
    for path, g, jg in zip(paths, tree_leaves(grads), tree_leaves(jgrads)):
        assert g.shape == jg.shape, path
        _close(g, jg, err_msg=str(path))
    if remat != "none":   # recomputation gives the same numbers
        (loss0, _), grads0 = _port_loss_grads(case_id, "none")
        assert torch.equal(loss, loss0)
        for g, g0 in zip(tree_leaves(grads), tree_leaves(grads0)):
            assert torch.equal(g, g0)


class _JaxLinear:
    """A loss linear in the parameters: its gradient is ``g`` exactly."""

    def __init__(self, g):
        self.g = g

    def loss(self, params, batch):
        terms = jax.tree.map(lambda p, g: jnp.sum(p * g), params, self.g)
        loss = sum(jax.tree.leaves(terms))
        return loss, {"loss": loss}


class _PortLinear:
    def __init__(self, g):
        self.g = g

    def loss(self, params, batch):
        loss = sum(torch.sum(p * g) for p, g in zip(tree_leaves(params),
                                                    tree_leaves(self.g)))
        return loss, {"loss": loss}


def _random_like(tree, rng):
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("case_id", ["dense", "hybrid", "encdec"])
def test_adamw_update_matches_jax(case_id, compression):
    """Two steps fed the same gradients; every per-block vector (``ln1``,
    ``ln2``, the Mamba vectors) must be decayed, as the JAX package decays
    its stacked rank-2 leaves, and the top-level norms must not be."""
    cfg, _, jparams, _ = _setup(case_id)
    rng = np.random.default_rng(7)
    params = _random_like(jparams, rng)          # no zero norm weights
    grads = [_random_like(jparams, rng) for _ in range(2)]
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
                compression=compression)
    jstate = j_init_train_state(jax.tree.map(jnp.asarray, params),
                                JOptConfig(**ocfg))
    state = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                           device="cpu")
    for g in grads:
        jstate, jm = jax.jit(j_make_train_step(
            _JaxLinear(jax.tree.map(jnp.asarray, g)), JOptConfig(**ocfg)))(
                jstate, {})
        state, m = make_train_step(
            _PortLinear(params_from_jax(cfg, g, device="cpu")),
            OptConfig(**ocfg))(state, {})
        _close(m["grad_norm"], jm["grad_norm"], rtol=1e-5, atol=0)
        _close(m["lr"], jm["lr"], rtol=1e-6, atol=0)
    want = state_from_jax(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert int(state["step"]) == int(want["step"]) == 2
    assert state.keys() == want.keys()
    for name in state.keys() - {"step"}:
        for (path, got), ref in zip(tree_paths(state[name]),
                                    tree_leaves(want[name])):
            _close(got, ref, rtol=1e-6, atol=1e-6,
                   err_msg=f"{name} {path}")
    ln1 = next(p for p, _ in tree_paths(state["params"]) if p[-1] in
               ("ln1", "ln"))
    assert decays(ln1, torch.zeros(3)) and \
        not decays(("final_norm",), torch.zeros(3))


@pytest.mark.parametrize("case_id", IDS)
def test_three_train_steps_match_jax(case_id):
    cfg, jm, jparams, data = _setup(case_id)
    jstate = j_init_train_state(jax.tree.map(jnp.asarray, jparams),
                                JOptConfig(**OPT))
    jstep = jax.jit(j_make_train_step(jm, JOptConfig(**OPT)))
    state = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                           device="cpu")
    step = make_train_step(get_model(cfg), OptConfig(**OPT))
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jmetrics = jstep(jstate, _jax_batch(batch))
        state, metrics = step(state, to_device(batch, "cpu"))
        for k in ("loss", "grad_norm", "lr", "tokens"):
            _close(metrics[k], jmetrics[k], err_msg=f"step {i} {k}")
        if i == 0:
            _, _, jgrads = _jax_loss_grads(case_id)
            want = params_from_jax(cfg, jax.tree.map(np.asarray,
                                                     jstate["params"]),
                                   device="cpu")
            for (path, p), jp, jg in zip(tree_paths(state["params"]),
                                         tree_leaves(want),
                                         tree_leaves(jgrads)):
                big = jg.abs() > 1e-3 * jg.abs().max()
                err = (p - jp).abs()[big]
                assert bool((err <= 1e-5 + 1e-4 * jp.abs()[big]).all()), \
                    (path, float(err.max()) if err.numel() else 0.0)
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(lr_at(OptConfig(**cfg), 0, device="cpu")) == 0.0
    assert float(lr_at(OptConfig(**cfg), 10, device="cpu")) == \
        pytest.approx(1e-3, rel=1e-3)
    assert float(lr_at(OptConfig(**cfg), 100, device="cpu")) == \
        pytest.approx(1e-4, rel=1e-2)
    steps = torch.arange(0, 121, dtype=torch.int32)
    got = lr_at(OptConfig(**cfg), steps)
    assert got.dtype == torch.float32
    want = j_lr_at(JOptConfig(**cfg), jnp.arange(0, 121, dtype=jnp.int32))
    _close(got, want, rtol=1e-6, atol=0)


def test_global_norm_clip():
    tree = {"a": torch.full((4,), 3.0), "b": [torch.full((4,), 4.0)]}
    clipped, g = clip_by_global_norm(tree, 1.0)
    assert float(g) == pytest.approx(10.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    jclipped, jg = j_clip({"a": jnp.full((4,), 3.0),
                           "b": [jnp.full((4,), 4.0)]}, 1.0)
    assert float(g) == float(jg)
    _close(clipped["b"][0], jclipped["b"][0], rtol=0, atol=0)


def test_quantize_dequantize_matches_jax():
    g = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    g[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 0.0, 127.0, -127.0]  # ties
    got = comp.quantize_dequantize(torch.from_numpy(g))
    err = (torch.from_numpy(g) - got).abs().max()
    assert float(err) <= float(np.abs(g).max() / 127.0) * 1.01
    assert np.array_equal(got.numpy(), np.asarray(
        jcomp.quantize_dequantize(jnp.asarray(g))))


def test_error_feedback_accumulates_like_jax():
    g = {"g": torch.full((1024,), 1e-4)}   # tiny gradient, big quant noise
    ef = {"g": torch.zeros(1024)}
    jg, jef = {"g": jnp.full((1024,), 1e-4)}, {"g": jnp.zeros((1024,))}
    total = torch.zeros(1024)
    for _ in range(50):
        ghat, ef = comp.compress_with_error_feedback(g, ef)
        jghat, jef = jcomp.compress_with_error_feedback(jg, jef)
        total = total + ghat["g"]
        _close(ghat["g"], jghat["g"], rtol=1e-6, atol=1e-9)
    assert float((total / 50 - 1e-4).abs().max()) < 5e-5


def test_int8_ef_compression_trains():
    class Toy:
        def loss(self, params, batch):
            loss = torch.mean((params["w"] - 3.0) ** 2)
            return loss, {"loss": loss}

    cfg = OptConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0,
                    compression="int8_ef")
    step = make_train_step(Toy(), cfg)
    state = init_train_state({"w": torch.zeros(2048)}, cfg)
    assert "ef" in state and state["step"].dtype == torch.int32
    for _ in range(50):
        state, m = step(state, {})
    assert float(m["loss"]) < 0.05


def test_ssd_chunked_gradient_where_reference_overflows():
    """ROADMAP C-ref-10: at a 256-step chunk whose decays overflow float32
    above the diagonal, the JAX ``ssd_chunked``'s gradients in dt and A
    are NaN (0 * inf through ``where``); the port's are finite and equal
    the gradients of the JAX sequential oracle ``ssd_reference`` to 2e-4
    of each input's largest (measured at most 9.7e-5: the chunked and the
    sequential scan sum 256 steps in other orders)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    rng = np.random.default_rng(4)
    b, s, h, p, n = 1, 256, 2, 8, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.3, 0.6, (b, s, h)).astype(np.float32)
    A = np.array([-1.0, -4.0], np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    w = rng.standard_normal((b, s, h, p)).astype(np.float32)

    def jloss(fn, **kw):
        return lambda *a: jnp.sum(fn(*a, **kw)[0] * w)
    args = (x, dt, A, B, C)
    jchunk = jax.grad(jloss(jssm.ssd_chunked, chunk=s), argnums=range(5))(
        *map(jnp.asarray, args))
    assert all(bool(jnp.isnan(g).any()) for g in jchunk[1:3])  # dt, A
    want = jax.grad(jloss(jssm.ssd_reference), argnums=range(5))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, _ = ssm.ssd_chunked(*ts, chunk=s)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    for name, g, jg in zip("x dt A B C".split(), got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(g, jg, err_msg=name, rtol=0, atol=2e-4 * float(
            np.abs(np.asarray(jg)).max()))


# ---------------------------------------------------------------------------
# the kernel guard
# ---------------------------------------------------------------------------

def _ssd_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 24, 2, 16, generator=g)
    dt = torch.rand(1, 24, 2, generator=g) * 0.1
    A = -torch.rand(2, generator=g)
    B = torch.randn(1, 24, 8, generator=g)
    C = torch.randn(1, 24, 8, generator=g)
    return [x, dt, A, B, C]


@pytest.mark.parametrize("which", range(5))
def test_ssd_scan_refuses_grad(which):
    args = _ssd_inputs()
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="ssd_chunked"):
        ssd_scan(*args, chunk=8)
    with torch.no_grad():
        y, _ = ssd_scan(*args, chunk=8)
    assert not y.requires_grad
    y, _ = ssd_scan(*(a.detach() for a in args), chunk=8)   # no grad asked
    state = torch.zeros(1, 2, 16, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ssd_scan(*(a.detach() for a in args), chunk=8, initial_state=state)


@pytest.mark.parametrize("which", range(3))
def test_flash_attention_refuses_grad(which):
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(1, 12, 4, 16, generator=g),
            torch.randn(1, 12, 2, 16, generator=g),
            torch.randn(1, 12, 2, 16, generator=g)]
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="attn_forward"):
        flash_attention(*args, causal=True)
    with torch.no_grad():
        assert not flash_attention(*args, causal=True).requires_grad


@pytest.mark.parametrize("case_id", ["dense", "ssm", "hybrid", "encdec"])
def test_prefill_runs_under_no_grad(case_id):
    """Parameters that require a gradient (as in a training step) do not
    trip the guard on the serve path: the prefills run without grad."""
    cfg, _, jparams, data = _setup(case_id)
    params = params_from_jax(cfg, jparams, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = to_device(data.batch_at(0), "cpu")
    batch.pop("labels")
    logits, _ = get_model(cfg).prefill(params, batch)
    assert not logits.requires_grad and bool(torch.isfinite(logits).all())
