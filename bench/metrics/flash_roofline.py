"""flash_roofline: the flash-attention kernel's least time over its device
time, in percent.  The device time sums the kernel's launches
(``kernels.flash_attention``: ``flash_wgmma_kernel`` for bf16,
``flash_fwd_kernel`` for float32) in the traced slice; each launch is one
shared-block application's causal self attention over a prefill of the
mix's prefix length, q [1, S, Hq, D] and k/v [1, S, Hkv, D] from the
configuration, and its least time is the larger of its operations over
the card's bf16 tensor-core peak and its bytes over the card's bandwidth.

The operations and bytes are a frozen copy of the program's
``kernels.flash_attention.flash_work`` (kept here so that a change to the
kernel cannot move the yardstick): 2 operations a multiply-add of Q.K^T
and of P.V over the (query, key) pairs a causal mask keeps, q, k, v read
once and o written once, two bytes a value."""
from bench import peaks

KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel")


def causal_pairs(sq, sk):
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def flash_work(b, sq, sk, hq, hkv, d, causal, elem):
    pairs = causal_pairs(sq, sk) if causal else sq * sk
    return 4 * b * hq * d * pairs, elem * (2 * b * sq * hq * d +
                                           2 * b * sk * hkv * d)


def bound_s(cfg, s, card):
    flops, nbytes = flash_work(1, s, s, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, True, 2)
    return max(flops / card["bf16_flops"], nbytes / card["hbm_bytes_per_s"])


def read(run):
    card = peaks.of(run.device["kind"])
    if run.trace is None or card is None:
        return None
    calls, busy = 0, 0.0
    for name, (n, sec) in run.trace.by_name().items():
        if any(k in name for k in KERNELS):
            calls, busy = calls + n, busy + sec
    if not calls or busy <= 0:
        return None
    return 100.0 * calls * bound_s(run.cfg, run.traffic["prefix_len"],
                                   card) / busy
