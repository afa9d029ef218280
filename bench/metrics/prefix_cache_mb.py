"""prefix_cache_mb: the bytes of one cached prefix of a published Zamba2
configuration, in MB (1e6 bytes): the program's process-wide counters
(``repro_torch.tracing.counters()``) ``hybrid.prefix_kv_bytes`` (the K/V of
every shared-block application) and ``hybrid.prefix_state_bytes`` (every
Mamba2 layer's SSD state and conv history), summed over the caches that
the run's prefills returned (set-up's and the window's), over
``hybrid.prefills``.  What a router's node holds a prefix, and so how many
prefixes a card's memory takes.  A program without the counters reads
nothing."""


def read(run):
    from repro_torch import tracing
    if not hasattr(tracing, "counters"):
        return None
    c = tracing.counters()
    n = c.get("hybrid.prefills", 0)
    if not n:
        return None
    return (c.get("hybrid.prefix_kv_bytes", 0) +
            c.get("hybrid.prefix_state_bytes", 0)) / n / 1e6
