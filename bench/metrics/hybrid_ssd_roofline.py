"""hybrid_ssd_roofline: ``ssd_roofline``'s rule for a Mamba2 layer with B/C
groups, in percent: the SSD scan's least time over the device time of its
five stages' kernels (``kernels.ssd``) in the traced slice, one call (one
``ssd_cumsum_kernel`` launch) a Mamba2 layer of a prefill of the mix's
prefix length.

The operations and bytes are a frozen copy of the program's grouped
``kernels.ssd.ssd_work``: per chunk of l rows, C.B^T over the l(l+1)/2
kept pairs once a group (a group's heads share its B and C), and per
head the weighted sum over those pairs (p wide), the inter-chunk product
and the state update (l*p*n each), two operations a multiply-add; x,
every group's B and C, dt, A read once, y and the final state written
once.  All of them count at the bf16 tensor-core peak (the bound is what
the card can do, not what this kernel does)."""
import importlib.util
from pathlib import Path

from bench import peaks


def _stages():
    spec = importlib.util.spec_from_file_location(
        "bench_metric_ssd_roofline_stages",
        Path(__file__).with_name("ssd_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STAGES


def ssd_work(b, s, h, p, n, chunk, elem, g):
    full, tail = divmod(s, chunk)
    pairs = full * (chunk * (chunk + 1) // 2) + tail * (tail + 1) // 2
    cb = b * g * 2 * n * pairs
    rest = b * h * (2 * p * pairs + 4 * s * p * n)
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (
        b * s * h + h + b * h * p * n)
    return cb, rest, nbytes


def bound_s(cfg, s, card):
    cb, rest, nbytes = ssd_work(1, s, cfg.ssm_heads, cfg.ssm_headdim,
                                cfg.ssm_state, min(cfg.ssm_chunk, s), 2,
                                getattr(cfg, "ssm_groups", 1))
    return max((cb + rest) / card["bf16_flops"],
               nbytes / card["hbm_bytes_per_s"])


def read(run):
    card = peaks.of(run.device["kind"])
    if run.trace is None or card is None:
        return None
    stages = _stages()
    calls, busy = 0, 0.0
    for name, (n, sec) in run.trace.by_name().items():
        if any(st in name for st in stages):
            busy += sec
            calls += n if stages[0] in name else 0
    if not calls or busy <= 0:
        return None
    return 100.0 * calls * bound_s(run.cfg, run.traffic["prefix_len"],
                                   card) / busy
