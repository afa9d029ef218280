"""prefill_graph_share: the share of the model's prefills on the card that
replayed a captured CUDA graph, ``prefill.graph_replays`` over
``prefill.graph_replays`` + ``prefill.eager_runs`` of the program's
process-wide counters (``repro_torch.tracing.counters()``), over the whole
run: set-up's prefills (the resident documents among them) and the
window's.  A prefill that captured its graph counts in neither.  A program
without the counters, or with no prefill on the card, reads nothing."""


def read(run):
    from repro_torch import tracing
    if not hasattr(tracing, "counters"):
        return None
    c = tracing.counters()
    replays = c.get("prefill.graph_replays", 0)
    runs = replays + c.get("prefill.eager_runs", 0)
    return replays / runs if runs else None
