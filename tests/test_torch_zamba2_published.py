"""The published Zamba2 block (zamba2-7b-instruct) on the CPU at a tiny size
with every mechanism present — the ``hybrid_layer_ids`` layout, 2 B/C
groups, per-application adapters and ``linear``s, [x, embeddings] into the
shared block, the (D/2)^-1/2 softmax scale — held against the benchmark's
plain reference (``bench/reference/zamba2-7b-instruct.py``), and that
reference against transformers' ``Zamba2ForCausalLM`` where it is
importable; the grouped SSD and flash at D = 224 with a scale against
plain versions; the mesh refusal."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import get_model, init_params
from repro_torch.models import ssm
from repro_torch.models.layers import attention_naive
from repro_torch.tree import tree_map_with_path

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "zamba2_7b_instruct_ref",
        ROOT / "bench" / "reference" / "zamba2-7b-instruct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(**over):
    """The published config at a tiny size: 4 layers, shared blocks before
    layers 1 and 3, d 64, 4 heads of 32 (2 d / heads, as the published
    block's), 8 Mamba heads of 16 in 2 groups, adapters of rank 8."""
    kw = dict(head_dim=32, attn_scale=16 ** -0.5, ssm_chunk=8)
    kw.update(over)
    return get_config("zamba2-7b-instruct").reduced(**kw)


def _params(cfg, seed=0):
    """Seeded weights, the norms and biases drawn too (the draw leaves
    them zero), so that the (1 + w) convention is exercised."""
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, "cpu")

    def jitter(path, t):
        if path[-1] in ("ln", "ln1", "ln2", "final_norm", "norm_w",
                        "conv_b"):
            return 0.1 * torch.randn(t.shape, generator=gen)
        return t
    return tree_map_with_path(jitter, params)


def _tokens(cfg, s, seed=1):
    return torch.randint(0, cfg.vocab, (1, s),
                         generator=torch.Generator().manual_seed(seed))


def test_published_layout_of_the_config():
    cfg = get_config("zamba2-7b-instruct")
    assert cfg.n_apps == 13 and cfg.hybrid_layer_ids[:3] == (6, 11, 17)
    assert cfg.conv_dim == 7168 + 2 * 2 * 64
    assert cfg.softmax_scale == 112 ** -0.5
    assert abs(cfg.param_count() - 7.357e9) < 1e6
    spec = get_model(cfg).cache_spec(1, 4096)
    assert spec["state"][0] == (81, 1, 112, 64, 64)
    assert spec["conv"][0] == (81, 1, 3, 7424)
    assert spec["k"][0] == (13, 1, 4096, 32, 224)


def test_prefill_then_decode_equal_the_plain_reference():
    """The serving path (prefill through the kernels' plain versions,
    then decode steps through the cache) against the reference's one
    full forward, in float32: both compute the same equations, so they
    differ by float32 rounding alone (5e-5 of the logits' scale)."""
    cfg = _cfg()
    model, params = get_model(cfg), _params(cfg)
    toks = _tokens(cfg, 23)
    ref = _reference().logits(params, dataclasses.asdict(cfg), toks[0],
                              list(range(23)), _matmul())
    logits, cache = model.prefill(params, {"tokens": toks[:, :19]},
                                  max_len=24)
    got = [logits[0]]
    for t in range(19, 23):
        logits, cache = model.decode_step(params, cache, toks[:, t])
        got.append(logits[0])
    scale = ref.abs().max()
    err = (torch.stack(got) - ref[18:]).abs().max()
    assert err <= 5e-5 * scale, (err, scale)
    full = model.forward(params, {"tokens": toks})[0]
    assert (full - ref).abs().max() <= 5e-5 * scale


def _matmul():
    from bench.reference.blocks import Matmul
    return Matmul(False)


def test_bf16_prefill_lies_near_the_reference_and_the_groups_matter():
    """At bf16 compute (the configuration's) the prefill stays near the
    float32 reference; reading one group where the layout has two moves
    the logits far more."""
    cfg = _cfg(dtype="bfloat16")
    model, params = get_model(cfg), _params(cfg)
    toks = _tokens(cfg, 20)
    ref = _reference().logits(params, dataclasses.asdict(cfg), toks[0],
                              [19], _matmul())[0]
    got = model.prefill(params, {"tokens": toks}, max_len=24)[0][0]
    err = float((got - ref).norm() / ref.norm())
    one = dataclasses.replace(cfg, ssm_groups=1)
    p1 = dict(params, layers=[
        {"ln": lp["ln"], "m": dict(lp["m"], **_first_group(cfg, lp["m"]))}
        for lp in params["layers"]])
    wrong = get_model(one).prefill(p1, {"tokens": toks}, max_len=24)[0][0]
    assert err < 0.05
    assert float((wrong - ref).norm() / ref.norm()) > 4 * err


def _first_group(cfg, m):
    """A Mamba block's in-projection, conv and norm cut to group 0's B/C."""
    di, gn, n = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_state
    keep = torch.cat([torch.arange(2 * di + n),
                      torch.arange(2 * di + gn, 2 * di + gn + n),
                      torch.arange(2 * di + 2 * gn, m["in_proj"].shape[1])])
    ck = torch.cat([torch.arange(di + n),
                    torch.arange(di + gn, di + gn + n)])
    return {"in_proj": m["in_proj"][:, keep], "conv_w": m["conv_w"][:, ck],
            "conv_b": m["conv_b"][ck]}


@pytest.mark.parametrize("s,chunk", [(37, 16), (64, 16), (5, 8)])
def test_grouped_ssd_equals_a_scan_a_group(s, chunk):
    """``ssd_scan`` (the kernel's plain version) and the differentiable
    ``ssd_chunked`` with B/C [b,s,g,n] against the sequential oracle run
    on each group's heads with that group's B and C."""
    gen = torch.Generator().manual_seed(s)
    b, h, p, n, g = 2, 8, 16, 12, 2
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen) * 0.2
    A = -torch.rand(h, generator=gen) - 0.5
    B = torch.randn(b, s, g, n, generator=gen)
    C = torch.randn(b, s, g, n, generator=gen)
    st0 = torch.randn(b, h, p, n, generator=gen)
    y, st = ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=st0)
    yc, stc = ssm.ssd_chunked(x, dt, A, B, C, chunk=chunk,
                              initial_state=st0)
    hg = h // g
    for k in range(g):
        hs = slice(k * hg, (k + 1) * hg)
        yr, sr = ssm.ssd_reference(x[:, :, hs], dt[:, :, hs], A[hs],
                                   B[:, :, k], C[:, :, k],
                                   initial_state=st0[:, hs])
        for got, want in ((y[:, :, hs], yr), (st[:, hs], sr),
                          (yc[:, :, hs], yr), (stc[:, hs], sr)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_grouped_decode_step_continues_the_scan():
    gen = torch.Generator().manual_seed(3)
    b, s, h, p, n, g = 1, 9, 4, 8, 6, 2
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen) * 0.3
    A = -torch.rand(h, generator=gen) - 0.5
    B, C = (torch.randn(b, s, g, n, generator=gen) for _ in range(2))
    y, st = ssm.ssd_reference(x, dt, A, B, C)
    state = torch.zeros(b, h, p, n)
    for t in range(s):
        state, yt = ssm.ssd_step(state, x[:, t], dt[:, t], A, B[:, t],
                                 C[:, t])
        torch.testing.assert_close(yt, y[:, t])
    torch.testing.assert_close(state, st)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_path_at_d224_with_a_scale(dtype):
    """The flash wrapper's plain version at the published head dim and
    scale against plain attention with the same scale (and differing
    from the default 1/sqrt(D))."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 70, 4, 224, generator=gen).to(dtype)
               for _ in range(3))
    scale = 112 ** -0.5
    got = flash_attention(q, k, v, causal=True, scale=scale)
    want = attention_naive(q.float(), k.float(), v.float(), causal=True,
                           scale=scale)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    default = flash_attention(q, k, v, causal=True)
    assert (default.float() - want).abs().max() > 10 * tol
    torch.testing.assert_close(
        default.float(), attention_naive(q.float(), k.float(), v.float(),
                                         causal=True), rtol=tol, atol=tol)


def test_the_published_block_refuses_a_mesh():
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import fake_world, make_mesh
    cfg = _cfg()
    model, params = get_model(cfg), _params(cfg)
    toks = _tokens(cfg, 6)
    _, cache = model.prefill(params, {"tokens": toks}, max_len=8)
    with fake_world(2):
        mesh = make_mesh((2,), ("model",), device_type="cpu")
        on_mesh = dict(params, embed=DTensor.from_local(
            params["embed"], mesh, [Replicate()], run_check=False))
        with pytest.raises(NotImplementedError, match="one device"):
            model.prefill(on_mesh, {"tokens": toks}, max_len=8)
        with pytest.raises(NotImplementedError, match="one device"):
            model.decode_step(on_mesh, cache, toks[:, 0])
    with pytest.raises(NotImplementedError, match="training"):
        model.loss(params, {"tokens": toks, "labels": toks})


def _hf_model(cfg, params):
    """transformers' ``Zamba2ForCausalLM`` at ``cfg``'s size with
    ``params`` mapped in (Linear weights are [out, in]; the published norm
    weight is 1 + w)."""
    tf = pytest.importorskip("transformers")
    ids = set(cfg.hybrid_layer_ids)
    hc = tf.Zamba2Config(
        vocab_size=cfg.vocab, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers,
        layers_block_type=["hybrid" if i in ids else "mamba"
                           for i in range(cfg.n_layers)],
        mamba_d_state=cfg.ssm_state, mamba_d_conv=cfg.ssm_conv,
        mamba_expand=cfg.ssm_expand, mamba_ngroups=cfg.ssm_groups,
        n_mamba_heads=cfg.ssm_heads, chunk_size=cfg.ssm_chunk,
        intermediate_size=cfg.d_ff, hidden_act="gelu",
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        num_mem_blocks=cfg.n_shared, use_shared_attention_adapter=False,
        adapter_rank=cfg.adapter_rank, use_mem_rope=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=True, time_step_min=1e-30,
        attn_implementation="eager")
    assert hc.attention_head_dim == cfg.head_dim
    torch.manual_seed(0)
    hf = tf.Zamba2ForCausalLM(hc).eval()
    T = lambda w: w.detach().T.contiguous()  # noqa: E731

    def norm(mod, w):
        mod.weight.data.copy_(1.0 + w)

    def mamba(mod, lp):
        m, mx = lp["m"], mod.mamba
        norm(mod.input_layernorm, lp["ln"])
        mx.in_proj.weight.data.copy_(T(m["in_proj"]))
        mx.conv1d.weight.data.copy_(T(m["conv_w"])[:, None, :])
        mx.conv1d.bias.data.copy_(m["conv_b"])
        for name in ("dt_bias", "A_log", "D"):
            getattr(mx, name).data.copy_(m[name])
        norm(mx.norm, m["norm_w"])
        mx.out_proj.weight.data.copy_(T(m["out_proj"]))

    model = hf.model
    model.embed_tokens.weight.data.copy_(params["embed"])
    hf.lm_head.weight = model.embed_tokens.weight
    norm(model.final_layernorm, params["final_norm"])
    app = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
    for i, layer in enumerate(model.layers):
        lp = params["layers"][i]
        if i not in app:
            mamba(layer, lp)
            continue
        j = app[i]
        sp, ap = params["shared"][j % cfg.n_shared], params["apps"][j]
        mamba(layer.mamba_decoder, lp)
        layer.linear.weight.data.copy_(T(ap["linear"]))
        st = layer.shared_transformer
        for name in ("q", "k", "v", "o"):
            getattr(st.self_attn, f"{name}_proj").weight.data.copy_(
                T(sp["attn"][f"w{name}"]))
        norm(st.input_layernorm, sp["ln1"])
        norm(st.pre_ff_layernorm, sp["ln2"])
        ff = st.feed_forward
        ff.gate_up_proj.weight.data.copy_(
            T(torch.cat([sp["mlp"]["wg"], sp["mlp"]["wi"]], dim=1)))
        ff.down_proj.weight.data.copy_(T(sp["mlp"]["wo"]))
        ad = ff.gate_up_proj_adapter_list[j]
        ad[0].weight.data.copy_(T(ap["adapter_a"]))
        ad[1].weight.data.copy_(T(ap["adapter_b"]))
    return hf


def test_plain_reference_equals_transformers_zamba2():
    """The benchmark's plain reference against transformers'
    ``Zamba2ForCausalLM`` (eager attention, its plain-torch Mamba path)
    with the same weights, every position's logits, in float32.  The
    sequence lies within one SSD chunk: transformers' plain-torch scan
    (4.57) sums its carry between chunks over the target chunk's axis
    (``(decay_chunk[..., None, None] * states_permuted[:, :, None,
    ...]).sum(dim=2)``), so past a chunk boundary it leaves the recurrence
    that its CUDA path and the reference compute (the reference's scan is
    held to the step-by-step recurrence in ``bench/test_bench_reference``,
    the port's grouped scan above)."""
    cfg = _cfg(ssm_chunk=32)
    params = _params(cfg, seed=7)
    hf = _hf_model(cfg, params)
    toks = _tokens(cfg, 21, seed=8)
    with torch.no_grad():
        want = hf(input_ids=toks, use_cache=False).logits[0]
    ref = _reference().logits(params, dataclasses.asdict(cfg), toks[0],
                              list(range(21)), _matmul())
    assert want.shape == ref.shape
    assert (ref - want).abs().max() <= 1e-4 * want.abs().max()
    assert math.isfinite(float(want.abs().max()))
