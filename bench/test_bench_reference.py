"""The plain references agree with the port on the CPU: the models at a
tiny float32 size (prefill logits, and the tokens decoded through the
cache read against the reference's full forward pass), the router request
by request over a long stream under every policy; and the weights come in
the program's layout, the same for the same seed."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import check, streams, weights
from bench.conftest import TINY
from bench.reference import blocks, router

BENCH = Path(__file__).resolve().parent


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"t_ref_{name.replace('-', '_').replace('.', '_')}",
        BENCH / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(name, **over):
    import json
    model = json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "model"]
    model.update(TINY[name], dtype="float32", **over)
    return model


@pytest.mark.parametrize("length", [37, 48])
def test_reference_agrees_with_the_port_float32(length):
    """A document that ends inside a chunk (37) and one that fills its
    last chunk (48, chunks of 16)."""
    name = "mamba2-370m"
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    model = _model(name)
    cfg = ModelConfig(**model)
    params = weights.draw(init_params(cfg, device="meta"), 5, "cpu")
    eng = ServeEngine(cfg, params=params, device="cpu")
    ref = _reference(name)
    doc = streams.Documents(5, cfg.vocab, length)(3)
    logits, kv = eng.prefill(doc, max_len=length + 6)
    out, _ = eng.decode(kv, np.zeros((1,), np.int32), 5)
    seq = torch.as_tensor(np.r_[doc[0], 0, out[0, :-1]], dtype=torch.int64)
    want = ref.logits(params, model, seq, list(range(length - 1,
                                                     length + 5)),
                      blocks.Matmul())
    assert float((logits[0] - want[0]).norm() / want[0].norm()) < 1e-5
    for k, tok in enumerate(out[0]):
        row = want[k + 1]
        assert float(row.max()) - check._served(row, int(tok),
                                                cfg.vocab) < 1e-4


def test_selective_scan_equals_the_step_by_step_recurrence():
    g = torch.Generator().manual_seed(0)
    s, h, p, n = 45, 3, 4, 5
    x = torch.randn(s, h, p, generator=g)
    dt = torch.rand(s, h, generator=g) * 0.5
    A = -torch.rand(h, generator=g) * 2
    B, C = torch.randn(s, n, generator=g), torch.randn(s, n, generator=g)
    state = torch.zeros(h, p, n)
    ys = []
    for t in range(s):
        state = state * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None, None] * x[t][:, :, None]) * B[t]
        ys.append(state @ C[t])
    got = blocks.selective_scan(x, dt, A, B, C, chunk=8)
    assert torch.allclose(got, torch.stack(ys), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("policy", ["fna_cal", "fna", "fno", "pi"])
def test_router_reference_equals_the_program_request_by_request(policy):
    from repro_torch.serving import ClusterConfig, PrefixServeCluster
    cluster = {"n_nodes": 4, "node_capacity": 8, "update_interval": 4,
               "miss_penalty": 40.0, "policy": policy}
    keys = streams.recency_trace(2500, 0.2, 64, 1.2, 4) * 4 + 2**40
    prog = PrefixServeCluster(ClusterConfig(**cluster), seed=123)
    probed = []
    for j, node in enumerate(prog.nodes):
        def lookup(key, j=j, found=node.lookup):
            probed.append(j)
            return found(key)
        node.lookup = lookup
    got = []
    for key in keys:
        probed.clear()
        miss = []
        prog.request(int(key), make_kv=lambda: miss.append(1) or True)
        got.append((tuple(probed), not miss))
    want = router.replay(cluster, 123, keys)
    assert got == want
    assert 0 < sum(h for _, h in want) < len(want)


def test_weights_follow_the_program_layout_and_the_seed():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_params
    cfg = ModelConfig(**_model("mamba2-370m"))
    layout = init_params(cfg, device="meta")
    a = weights.draw(layout, 2**31 + 1, "cpu")
    b = weights.draw(layout, 2**31 + 1, "cpu")
    c = weights.draw(layout, 2**31 + 2, "cpu")
    la, lb, lc = (weights._leaves(t) for t in (a, b, c))
    ll = weights._leaves(layout)
    assert [p for p, _ in la] == [p for p, _ in ll]
    for (p, x), (_, y), (_, z), (_, m) in zip(la, lb, lc, ll):
        assert x.shape == m.shape and x.dtype == m.dtype
        assert torch.equal(x, y)
        if x.dim() >= 2:
            assert not torch.equal(x, z)
            lim = 2.0 * weights._scale(p, x) * (1 + 1e-5)
            assert float(x.abs().max()) <= lim
    a_log = a["layers"][0]["m"]["A_log"]
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0) + 1e-6)).all())
    assert torch.equal(a["layers"][0]["m"]["D"], torch.ones_like(a_log))
