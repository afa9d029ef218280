"""hybrid_prefill_mfu: the model FLOPs of the window's untraced prefills of
a published Zamba2 configuration (``hybrid_layer_ids``) over their
host-clock time (``ServeEngine.prefill`` to a device sync) and the card's
bf16 peak, in percent: the whole prefill step's share of the chip.

Model FLOPs of one prefill of S tokens, counted from the configuration's
shapes, two a multiply-add: every Mamba2 layer's projections (in: d x (2
d_inner + 2 g N + H), out: d_inner x d) and its grouped SSD scan (the
frozen ``ssd_work`` of ``hybrid_ssd_roofline``); every shared-block
application's q/k/v (the [x, embeddings] input, 2 d wide, to Hq x D and
2 Hkv x D), o (Hq x D to d), gate/up (d x 2 d_ff) with its adapter (d x r
then r x 2 d_ff), down (d_ff x d) and ``linear`` (d x d), and its causal
attention (4 Hq D over the kept pairs); the head at the last token only.
Norms, the conv, rotary and the element-wise work are left out.  Another
configuration has no count here, and reads nothing."""
import importlib.util
from pathlib import Path

from bench import peaks


def _ssd():
    spec = importlib.util.spec_from_file_location(
        "bench_metric_hybrid_ssd_roofline",
        Path(__file__).with_name("hybrid_ssd_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prefill_flops(cfg, s):
    ids = getattr(cfg, "hybrid_layer_ids", ())
    if cfg.family != "hybrid" or not ids:
        return None
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    g, f, r = cfg.ssm_groups, cfg.d_ff, cfg.adapter_rank
    cb, rest, _ = _ssd().ssd_work(1, s, h, cfg.ssm_headdim, n,
                                  min(cfg.ssm_chunk, s), 2, g)
    mamba = 2 * s * (d * (2 * di + 2 * g * n + h) + di * d) + cb + rest
    din = 2 * d
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pairs = s * (s + 1) // 2
    shared = 2 * s * (din * (hq + 2 * hkv) * hd + hq * hd * d +
                      d * 2 * f + r * (d + 2 * f) + f * d + d * d) + \
        4 * hq * hd * pairs
    return cfg.n_layers * mamba + len(ids) * shared + \
        2 * d * cfg.vocab_padded


def read(run):
    card = peaks.of(run.device["kind"])
    times = [r.prefill_s for r in run.requests if not r.hit]
    if card is None or not times:
        return None
    flops = prefill_flops(run.cfg, run.traffic["prefix_len"])
    if flops is None:
        return None
    return 100.0 * flops * len(times) / (sum(times) * card["bf16_flops"])
