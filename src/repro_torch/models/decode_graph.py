"""A model's whole decode step as one CUDA graph, replayed once a token.

At batch 1 an eager decode step is thousands of small device operations,
and the host's dispatch of them, not the card, sets its time.  The step's
shapes are fixed by its input layout and nothing in it syncs the host, so
:class:`DecodeGraphs` captures it once per layout (``torch.cuda.graphs``)
and replays it: one graph launch a token, the same operations at the same
precision.

It wraps the model's eager step ``body(params, cache, tokens) -> (logits,
cache)``, which writes the new cache into the cache's tensors in place.
A graph has static inputs (the tokens and every cache tensor) and a static
logits output.  A call served by a graph copies the caller's tokens and
cache into the static inputs, replays, copies the new cache back into the
caller's tensors and returns a copy of the logits: callers keep each
step's logits, and the next replay overwrites the static ones.

A graph engages only where the input shows that it is safe: autograd off;
the tokens, every cache value and every parameter leaf a plain
``torch.Tensor`` (no DTensor: the tensor-parallel path stays eager) on one
CUDA device; the current stream not capturing; no Python dispatch mode
active (the dry run's cost trace has to see every operation).  Anything
else runs ``body`` as it is: the CPU, the meta device, DTensors.

A graph is keyed by the layout (device, inference mode, the tokens' and
each cache tensor's shape and dtype) and holds the ``params`` object it
was captured with, compared by identity: another ``params`` object
recaptures.  It reads its weights' storage at every replay, so weights
updated in place are read by the next replay.  A leaf replaced by another
tensor in the same ``params`` object is not seen: the graph keeps reading
the leaf it captured (and holds it alive).  At most :data:`KEEP` graphs
live at once; the least recently used is dropped with its memory pool.

Counters (``repro_torch.tracing``): ``decode.graph_captures`` counts a call
that captured (it warms ``body`` on a side stream, captures, and replays
once for its own result), ``decode.graph_replays`` a call served by an
existing graph, and ``decode.eager_steps`` a call that ran ``body`` on a
CUDA device.  ``n`` steps of one layout count one capture and ``n - 1``
replays.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import tracing
from repro_torch.tree import tree_leaves

#: eager runs of the body on a side stream before a capture
#: (``torch.cuda.graphs`` asks for a few: lazy initialisation, such as
#: cuBLAS's handles and workspaces, must not happen inside the capture)
WARMUP = 3
#: graphs kept a model (a layout served, and one more)
KEEP = 2


class _Graph:
    """One captured step: its graph, the ``params`` it read and their
    leaves (held alive), its static tokens and cache, its static logits."""
    __slots__ = ("graph", "params", "leaves", "tokens", "cache", "logits")


class DecodeGraphs:
    """A model's captured decode steps, at most :data:`KEEP` of them, the
    most recently used last."""

    def __init__(self):
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()

    def __call__(self, body: Callable, params, cache: Dict[str, Any],
                 tokens) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``body(params, cache, tokens)``, through a graph where the inputs
        allow one."""
        key = _layout(cache, tokens)
        if key is None:
            return _eager(body, params, cache, tokens)
        g = self._graphs.get(key)
        if g is not None and g.params is params:
            self._graphs.move_to_end(key)
            tracing.count("decode.graph_replays")
        else:
            leaves = tree_leaves(params)
            if not all(_plain(t, tokens.device) for t in leaves):
                return _eager(body, params, cache, tokens)
            g = self._capture(key, body, params, leaves, cache, tokens)
            tracing.count("decode.graph_captures")
        g.tokens.copy_(tokens)
        for name, t in cache.items():
            g.cache[name].copy_(t)
        g.graph.replay()
        for name, t in cache.items():
            t.copy_(g.cache[name])
        return g.logits.clone(), cache

    def _capture(self, key: Tuple, body: Callable, params,
                 leaves: List[torch.Tensor], cache: Dict[str, Any],
                 tokens) -> _Graph:
        """Capture ``body`` over new static buffers of ``cache``'s and
        ``tokens``' layout; the caller's tensors are not touched."""
        self._graphs.pop(key, None)          # the old params' graph
        while len(self._graphs) >= KEEP:
            self._graphs.popitem(last=False)
        g = _Graph()
        g.params, g.leaves = params, leaves
        g.tokens = torch.zeros(tokens.shape, dtype=tokens.dtype,
                               device=tokens.device)
        g.cache = {name: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                   for name, t in cache.items()}
        main = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body(params, g.cache, g.tokens)
        main.wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph):
            g.logits, _ = body(params, g.cache, g.tokens)
        self._graphs[key] = g
        return g


def _eager(body: Callable, params, cache, tokens):
    if isinstance(tokens, torch.Tensor) and tokens.is_cuda:
        tracing.count("decode.eager_steps")
    return body(params, cache, tokens)


def _plain(t, device: torch.device) -> bool:
    return type(t) is torch.Tensor and t.device == device


def _layout(cache: Dict[str, Any], tokens) -> Optional[Tuple]:
    """The key of the graph for these inputs, or None where no graph may
    run them (module docstring)."""
    if torch.is_grad_enabled() or _get_current_dispatch_mode() is not None:
        return None
    if type(tokens) is not torch.Tensor or not tokens.is_cuda or \
            torch.cuda.is_current_stream_capturing():
        return None
    dev = tokens.device
    key = [dev, torch.is_inference_mode_enabled(), tokens.shape,
           tokens.dtype]
    for name, t in cache.items():
        if not _plain(t, dev):
            return None
        key.append((name, t.shape, t.dtype))
    return tuple(key)
