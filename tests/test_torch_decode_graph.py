"""The decode step's and the prefill's CUDA graphs off the card
(``models.decode_graph``): the process-wide counters of
``repro_torch.tracing``; ``Mamba2LM.decode_step`` and ``Mamba2LM.prefill``
on the CPU run their eager bodies bit for bit and count no capture, replay
or eager run on the card; the meta device's dry run of decode and of the
prefill still traces every operation; with the CUDA parts stood in for on
the CPU, a mixed stream of prompt lengths captures each of the first two
lengths that recur once and never evicts them, and decode keeps its rule.
The published Zamba2 block's graph reads its K/V
length from a 0-d device tensor: the decode attention with such a length
is the int-length path bit for bit, the rotary frequencies kept on the
device are ``rope_freqs``, and its ``decode_step`` gives the same logits
and cache from an int length and from a tensor one.  The graph itself
runs only on a card (``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import get_model, init_params
from repro_torch.models import layers as L
from repro_torch.serving import ServeEngine


@pytest.fixture(autouse=True)
def _fresh_counters():
    """Each test starts and ends with no counters; tiny eager ops run far
    faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset_counters()
    yield
    tracing.reset_counters()
    torch.set_num_threads(n)


def test_counters_count_read_and_reset():
    assert tracing.counters() == {}
    tracing.count("decode.graph_replays")
    tracing.count("decode.graph_replays", 3)
    tracing.count("decode.eager_steps", 0)
    got = tracing.counters()
    assert got == {"decode.graph_replays": 4, "decode.eager_steps": 0}
    got["decode.graph_replays"] = 100          # a copy
    assert tracing.counters()["decode.graph_replays"] == 4
    tracing.reset_counters()
    assert tracing.counters() == {}


def test_counters_stay_on_while_the_span_recorder_is_off():
    tracing.disable()
    tracing.count("x")
    tracing.enable()
    tracing.count("x")
    tracing.disable()
    assert tracing.counters() == {"x": 2}


def _mamba(seed=3):
    cfg = get_config("mamba2-370m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_decode_step_is_the_eager_body_and_counts_nothing(grad):
    """Four steps through ``decode_step`` and through the eager body on a
    copy of the same prefix cache: equal logits and caches, bit for bit,
    with autograd on or off; no counter moves on the CPU."""
    cfg, params = _mamba()
    model = get_model(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    _, cache = ServeEngine(cfg, params=params, device="cpu").prefill(
        toks, max_len=32)
    mine = {k: v.clone() for k, v in cache.items()}
    step = torch.as_tensor([5, 7])
    with torch.set_grad_enabled(grad):
        for _ in range(4):
            got, out = model.decode_step(params, cache, step)
            want, mine = model._decode_eager(params, mine, step)
            assert out is cache
            assert torch.equal(got, want)
            for name in cache:
                assert torch.equal(cache[name], mine[name])
            step = torch.argmax(got, -1)
    assert tracing.counters() == {}
    assert not model._graphs._graphs


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_prefill_is_the_eager_body_and_counts_nothing(grad):
    """``prefill`` and its eager body on the same tokens: equal logits,
    SSD states and conv histories, bit for bit, with autograd on or off
    (neither records a graph of autograd); a second prefill returns
    tensors of its own; no counter moves on the CPU and no graph is
    kept."""
    cfg, params = _mamba()
    model = get_model(cfg)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)))}
    with torch.set_grad_enabled(grad):
        got, cache = model.prefill(params, batch)
        want, mine = model._prefill_eager(params, batch)
        again, other = model.prefill(params, batch)
    assert torch.equal(got, want) and not got.requires_grad
    assert set(cache) == set(mine) == {"state", "conv"}
    for name in cache:
        assert cache[name].dtype == mine[name].dtype
        assert torch.equal(cache[name], mine[name])
        assert torch.equal(other[name], mine[name])
        assert other[name].data_ptr() != cache[name].data_ptr()
    assert again.data_ptr() != got.data_ptr()
    assert tracing.counters() == {}
    assert not model._prefill_graphs._graphs


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the body on the
    graph's static inputs and writes its results into the static
    outputs, as a replay of the captured kernels would."""

    def __init__(self, g, run):
        self.g, self.run = g, run

    def replay(self):
        from torch.utils._pytree import tree_leaves
        for static, new in zip(tree_leaves(self.g.outputs),
                               tree_leaves(self.run(self.g.inputs))):
            static.copy_(new)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """``models.decode_graph`` with its CUDA parts stood in for on the
    CPU: any input with autograd off takes a graph keyed by its names,
    shapes and dtypes, and a capture builds static buffers around a
    :class:`_StandInGraph`.  The rule of when to capture, evict or run
    eagerly is the module's own."""
    from repro_torch.models import decode_graph as dg

    def layout(inputs):
        if torch.is_grad_enabled():
            return None
        return tuple((n, t.shape, t.dtype) for n, t in inputs.items())

    def capture(self, key, params, leaves, inputs, run):
        g = dg._Graph()
        g.params, g.leaves, g.launches = params, leaves, []
        g.inputs = {n: torch.zeros_like(t) for n, t in inputs.items()}
        g.outputs = run(g.inputs)
        g.graph = _StandInGraph(g, run)
        self._graphs[key] = g
        return g

    monkeypatch.setattr(dg, "_layout", layout)
    monkeypatch.setattr(dg.StepGraphs, "_capture", capture)
    return dg


def test_prefill_graphs_capture_recurring_lengths_and_never_thrash(
        cpu_graphs):
    """A stream of prompt lengths in rotation, three of them recurring
    and some seen once, through ``prefill``: a length is captured at its
    second prefill, into a free place only, so the first two lengths to
    recur keep the two graphs, the third runs the eager body at every
    prefill, and nothing is captured twice; each prefill's logits, state
    and conv equal the eager body's bit for bit, in tensors of its own.
    A new ``params`` object's recurring length takes the place of the
    least recently used graph held for the old one."""
    cfg, params = _mamba()
    model = get_model(cfg)
    rng = np.random.default_rng(4)
    stream = [40, 24, 40, 56, 24, 40, 56, 33, 24, 56, 71, 40, 56, 24]
    kept = []
    with torch.no_grad():
        for s in stream:
            batch = {"tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab, (1, s)))}
            got, cache = model.prefill(params, batch)
            want, mine = model._prefill_eager(params, batch)
            assert torch.equal(got, want)
            for name in mine:
                assert torch.equal(cache[name], mine[name])
            kept.append(((got, cache), (want, mine)))
    for (got, cache), (want, mine) in kept:          # untouched by replays
        assert torch.equal(got, want)
        for name in mine:
            assert torch.equal(cache[name], mine[name])
    graphs = model._prefill_graphs._graphs
    assert sorted(key[0][1][1] for key in graphs) == [24, 40]
    assert tracing.counters() == {"prefill.graph_captures": 2,
                                  "prefill.graph_replays": 4}
    _, other = _mamba(seed=5)
    batch = {"tokens": torch.zeros((1, 56), dtype=torch.int64)}
    with torch.no_grad():
        got, _ = model.prefill(other, batch)
        assert torch.equal(got, model._prefill_eager(other, batch)[0])
    assert sorted(key[0][1][1] for key in graphs) == [24, 56]
    assert tracing.counters()["prefill.graph_captures"] == 3


def test_decode_graphs_capture_at_once_and_evict_the_least_recent(
        cpu_graphs):
    """Decode steps keep their rule: a layout is captured at its first
    step, and a third layout evicts the least recently used graph."""
    from repro_torch.models.decode_graph import DecodeGraphs
    graphs = DecodeGraphs()

    def body(params, cache, tokens):
        cache["h"].add_(tokens)
        return cache["h"] * params["w"], cache

    params = {"w": torch.tensor(2.0)}
    with torch.no_grad():
        for b in (1, 1, 2, 3, 1):
            cache = {"h": torch.ones(b)}
            got, out = graphs(body, params, cache, torch.ones(b))
            assert out is cache
            assert torch.equal(cache["h"], torch.full((b,), 2.))
            assert torch.equal(got, torch.full((b,), 4.))
    assert [key[1][1][0] for key in graphs._graphs] == [3, 1]
    assert tracing.counters() == {"decode.graph_captures": 4,
                                  "decode.graph_replays": 1}


def test_every_kernel_launch_counter_is_registered():
    """The kernels' ``LAUNCHES`` are the counters a graph's replay adds
    to (``kernels.LAUNCH_COUNTERS``)."""
    from repro_torch import kernels
    from repro_torch.kernels import bloom, flash_attention, ssd, subsetdp
    for mod in (bloom, flash_attention, ssd, subsetdp):
        assert any(c is mod.LAUNCHES for c in kernels.LAUNCH_COUNTERS)


def test_serve_engine_decode_on_cpu_counts_nothing():
    cfg, params = _mamba()
    eng = ServeEngine(cfg, params=params, device="cpu")
    _, cache = eng.prefill(np.ones((1, 10), np.int64), max_len=16)
    before = {k: v.clone() for k, v in cache.items()}
    toks, _ = eng.decode(cache, np.zeros(1, np.int32), 3)
    assert toks.shape == (1, 3)
    for name in cache:
        assert torch.equal(cache[name], before[name])
    assert tracing.counters() == {}


def test_meta_dry_run_of_decode_traces_every_operation():
    """The dry run's decode step on the meta device runs the eager body
    under its cost trace: operations and FLOPs counted, no graph."""
    from repro_torch.launch import dryrun
    cfg = get_config("mamba2-370m").reduced()
    shape = ShapeConfig("small", 64, 2, "decode")
    got = dryrun.run_traced(*dryrun.build_step(cfg, shape, None,
                                               torch.device("meta")))
    assert got["ops"] > 0 and got["flops"] > 0
    assert tracing.counters() == {}



def test_meta_dry_run_of_prefill_traces_every_operation():
    """The dry run's prefill on the meta device runs the eager body under
    its cost trace: the operations, FLOPs and SSD calls of the eager body
    traced on its own, and no graph."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import CostTrace
    cfg = get_config("mamba2-370m").reduced()
    shape = ShapeConfig("small", 64, 2, "prefill")
    step, args = dryrun.build_step(cfg, shape, None, torch.device("meta"))
    got = dryrun.run_traced(step, args)
    with torch.no_grad(), CostTrace() as tr:
        get_model(cfg)._prefill_eager(*args)
    assert got["ops"] == tr.ops > 0 and got["flops"] == tr.flops > 0
    assert got["kernel_calls"] == {"ssd_scan": cfg.n_layers}
    assert tracing.counters() == {}

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,scale", [(4, 2, 64, 0.0),
                                            (32, 32, 224, 112 ** -0.5)])
def test_decode_attention_with_a_tensor_length_is_the_int_path(hq, hkv, d,
                                                               scale, dtype):
    """GQA at D = 64 and the published block's 32/32 heads at D = 224:
    ``attn_decode_forward`` with a 0-d tensor length writes k, v at the
    same position and returns the same output as with the int, and
    ``attention_decode`` masks alike at every length; bit for bit."""
    cfg = dataclasses.replace(get_config("smollm-135m"), d_model=48,
                              n_heads=hq, n_kv_heads=hkv, head_dim=d,
                              attn_scale=scale)
    gen = torch.Generator().manual_seed(d + hq)
    p = {k: w.to(dtype) for k, w in
         L.init_attn(gen, cfg, torch.float32).items()}
    x = torch.randn(2, 1, 48, generator=gen).to(dtype)
    smax, n = 12, 7
    k0, v0 = (torch.randn(2, smax, hkv, d, generator=gen).to(dtype)
              for _ in range(2))
    ki, vi, kt, vt = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    want = L.attn_decode_forward(p, x, cfg, ki, vi, n)
    got = L.attn_decode_forward(p, x, cfg, kt, vt, torch.tensor(n))
    assert torch.equal(got, want)
    assert torch.equal(kt, ki) and torch.equal(vt, vi)
    rest = [i for i in range(smax) if i != n]
    assert torch.equal(ki[:, rest], k0[:, rest])
    assert not torch.equal(ki[:, n], k0[:, n])
    q = torch.randn(2, 1, hq, d, generator=gen).to(dtype)
    for length in (1, n, smax):
        assert torch.equal(
            L.attention_decode(q, k0, v0, torch.tensor(length),
                               scale=cfg.softmax_scale),
            L.attention_decode(q, k0, v0, length, scale=cfg.softmax_scale))
    with pytest.raises(ValueError, match="one device"):
        L.attn_decode_forward(p, x, cfg, kt, vt, torch.tensor(n),
                              seq=L.SeqShard(0, 2, ()))


def test_rope_frequencies_kept_on_the_device_are_rope_freqs():
    """Made once per (head dim, theta, device) from ``rope_freqs``, the
    same float32 values, and ``apply_rope`` with them equals the rotation
    with frequencies copied from the host at the call."""
    cpu = torch.device("cpu")
    for d, theta in ((64, 10000.0), (224, 10000.0), (112, 500000.0)):
        f = L.rope_freqs_on(d, theta, cpu)
        assert f.dtype == torch.float32 and f.device == cpu
        assert torch.equal(f, torch.from_numpy(L.rope_freqs(d, theta)))
        assert L.rope_freqs_on(d, theta, cpu) is f
    x = torch.randn(2, 5, 3, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(3, 8)[None]
    ang = pos[..., None].float() * torch.as_tensor(L.rope_freqs(64, 1e4))
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    want = torch.cat([x[..., :32] * cos - x[..., 32:] * sin,
                      x[..., 32:] * cos + x[..., :32] * sin], dim=-1)
    assert torch.equal(L.apply_rope(x, pos, 1e4), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_cost_trace_of_rotary_counts_alike_first_and_after(device):
    """The dry run's cost trace counts the same operations for the call
    that makes a (head dim, theta, device)'s frequencies as for a later
    one: they are made outside the trace."""
    from repro_torch.launch.cost import CostTrace
    x = torch.zeros(1, 3, 2, 48, device=device)
    pos = torch.arange(3, device=device)[None]
    ops = []
    for _ in range(2):
        with CostTrace() as tr:
            L.apply_rope(x, pos, 4321.0 if device == "cpu" else 4322.0)
        ops.append(tr.ops)
    assert ops[0] == ops[1] > 0


def test_published_decode_step_takes_an_int_or_a_tensor_length():
    """From one prefill's cache, four steps with the prefill's int length
    and four with the same length as a 0-d tensor: equal logits and
    caches, bit for bit; the length advances by one a step (in place
    where it is a tensor, into a tensor where it was an int, leaving the
    prefill's cache as it was); every step runs the body on the CPU
    (each application of the shared blocks counted), no graph."""
    cfg = get_config("zamba2-7b-instruct").reduced(
        head_dim=32, attn_scale=16 ** -0.5, ssm_chunk=8)
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.randint(0, cfg.vocab, (1, 13),
                         generator=torch.Generator().manual_seed(3))
    _, cache = model.prefill(params, {"tokens": toks[:, :9]}, max_len=16)
    assert cache["len"] == 9 and not isinstance(cache["len"], torch.Tensor)
    a = {k: v.clone() if isinstance(v, torch.Tensor) else v
         for k, v in cache.items()}
    b = {k: v.clone() if isinstance(v, torch.Tensor) else torch.tensor(v)
         for k, v in cache.items()}
    n_b = b["len"]
    for t in range(9, 13):
        la, a = model.decode_step(params, a, toks[:, t])
        lb, out = model.decode_step(params, b, toks[:, t])
        assert out is b and b["len"] is n_b
        assert torch.equal(la, lb)
        for name in cache:
            assert torch.equal(a[name], b[name]), name
        assert a["len"].dtype == torch.int64 and a["len"].dim() == 0
        assert int(a["len"]) == int(b["len"]) == t + 1
    assert cache["len"] == 9
    assert tracing.counters() == {"hybrid.prefills": 1,
                                  "hybrid.prefix_kv_bytes":
                                  cache["k"].nbytes + cache["v"].nbytes,
                                  "hybrid.prefix_state_bytes":
                                  cache["state"].nbytes +
                                  cache["conv"].nbytes,
                                  "hybrid.shared_apps": cfg.n_apps * 9}
    assert not model._graphs._graphs
