"""ssd_roofline: the SSD scan's least time over its device time, in
percent.  The device time sums the five stages' kernels (``kernels.ssd``'s
``ssd_{cumsum,cb,states,carry,out}_kernel``) in the traced slice; each
call (one ``ssd_cumsum_kernel`` launch) is one Mamba2 block of a prefill
of the mix's prefix length, and its least time is the larger of its
operations over the card's bf16 tensor-core peak and its bytes over the
card's bandwidth.

The operations and bytes are a frozen copy of the program's
``kernels.ssd.ssd_work`` (sound, and kept here so that a change to the
kernel cannot move the yardstick): per chunk of l rows, C.B^T over the
l(l+1)/2 kept pairs once (the heads share B and C), and per head the
weighted sum over those pairs (p wide), the inter-chunk product and the
state update (l*p*n each), two operations a multiply-add; x, B, C, dt, A
read once, y and the final state written once.  Every one of those
products is a matrix product of bf16 operands, so all of them count at
the bf16 tensor-core peak, whatever units the kernel happens to run them
on: the bound is what the card can do, not what this kernel does."""
from bench import peaks

STAGES = ("ssd_cumsum_kernel", "ssd_cb_kernel", "ssd_states_kernel",
          "ssd_carry_kernel", "ssd_out_kernel")


def ssd_work(b, s, h, p, n, chunk, elem):
    full, tail = divmod(s, chunk)
    pairs = full * (chunk * (chunk + 1) // 2) + tail * (tail + 1) // 2
    cb = b * 2 * n * pairs
    rest = b * h * (2 * p * pairs + 4 * s * p * n)
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (
        b * s * h + h + b * h * p * n)
    return cb, rest, nbytes


def bound_s(cfg, s, card):
    cb, rest, nbytes = ssd_work(1, s, cfg.ssm_heads, cfg.ssm_headdim,
                                cfg.ssm_state, min(cfg.ssm_chunk, s), 2)
    return max((cb + rest) / card["bf16_flops"],
               nbytes / card["hbm_bytes_per_s"])


def read(run):
    card = peaks.of(run.device["kind"])
    if run.trace is None or card is None:
        return None
    calls, busy = 0, 0.0
    for name, (n, sec) in run.trace.by_name().items():
        if any(st in name for st in STAGES):
            busy += sec
            calls += n if STAGES[0] in name else 0
    if not calls or busy <= 0:
        return None
    return 100.0 * calls * bound_s(run.cfg, run.traffic["prefix_len"],
                                   card) / busy
