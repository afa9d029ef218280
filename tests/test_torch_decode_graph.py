"""The decode step's CUDA graph off the card (``models.decode_graph``): the
process-wide counters of ``repro_torch.tracing``; ``Mamba2LM.decode_step``
on the CPU runs its eager body bit for bit and counts no capture, replay
or eager step on the card; the meta device's dry run of decode still
traces every operation.  The graph itself runs only on a card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import get_model, init_params
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

