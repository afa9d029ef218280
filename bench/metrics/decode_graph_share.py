"""decode_graph_share: the share of the model's decode steps on the card
that replayed a captured CUDA graph, ``decode.graph_replays`` over
``decode.graph_replays`` + ``decode.eager_steps`` of the program's
process-wide counters (``repro_torch.tracing.counters()``), over the whole
run: set-up's warm decodes and the window.  A step that captured its graph
counts in neither.  A program without the counters, or with no decode step
on the card, reads nothing."""


def read(run):
    from repro_torch import tracing
    if not hasattr(tracing, "counters"):
        return None
    c = tracing.counters()
    replays = c.get("decode.graph_replays", 0)
    steps = replays + c.get("decode.eager_steps", 0)
    return replays / steps if steps else None
