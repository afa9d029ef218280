"""prefill_mfu: the model FLOPs of the window's untraced prefills over
their host-clock time (``ServeEngine.prefill`` to a device sync) and the
card's bf16 peak, in percent: the whole prefill step's share of the chip,
which bounds what any one kernel's gain can bring.

Model FLOPs of one prefill of S tokens of a Mamba2 model (``ssm``),
counted from the configuration's shapes, two a multiply-add: every
block's projections (in: d x (2 d_inner + 2 N + H), out: d_inner x d),
the SSD scan (the frozen ``ssd_work`` of ``ssd_roofline``), and the head
at the last token only (the prefill returns that token's logits).  Norms,
the conv and the element-wise work are left out.  Another family has no
count here, and reads nothing."""
import importlib.util
from pathlib import Path

from bench import peaks


def _ssd():
    spec = importlib.util.spec_from_file_location(
        "bench_metric_ssd_roofline",
        Path(__file__).with_name("ssd_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prefill_flops(cfg, s):
    if cfg.family != "ssm":
        return None
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cb, rest, _ = _ssd().ssd_work(1, s, h, cfg.ssm_headdim, n,
                                  min(cfg.ssm_chunk, s), 2)
    mamba = 2 * s * (d * (2 * di + 2 * n + h) + di * d) + cb + rest
    return cfg.n_layers * mamba + 2 * d * cfg.vocab_padded


def read(run):
    card = peaks.of(run.device["kind"])
    times = [r.prefill_s for r in run.requests if not r.hit]
    if card is None or not times:
        return None
    flops = prefill_flops(run.cfg, run.traffic["prefix_len"])
    if flops is None:
        return None
    return 100.0 * flops * len(times) / (sum(times) * card["bf16_flops"])
