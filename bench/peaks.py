"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name`` gives (NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit; a card set below it
runs slower under load, so every share states the card's limit beside
it)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,      # tensor cores, bf16 and fp16
        "hbm_bytes_per_s": 3.35e12,
    },
}


def of(kind: str):
    """The card's peaks, or None for a card the table does not hold (a
    share of an unknown peak is not reported)."""
    return PEAKS.get(kind)
