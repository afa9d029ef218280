"""A model's decode step, or its prefill, as one CUDA graph replayed per
call.

At batch 1 an eager decode step is thousands of small device operations,
and the host's dispatch of them, not the card, sets its time; a 4k Mamba2
prefill is ≈ 2,850 of them, and its host dispatch too leaves the card
idle.  A step's shapes are fixed by its input layout and nothing in it
syncs the host, so :class:`StepGraphs` captures it once per layout
(``torch.cuda.graphs``) and replays it: one graph launch a call, the same
operations at the same precision.  :class:`DecodeGraphs` and
:class:`PrefillGraphs` put the two kinds of step on it.

A decode step's eager body ``body(params, cache, tokens) -> (logits,
cache)`` writes the new cache into the cache's tensors in place.  Its graph
has static inputs (the tokens and every cache tensor) and a static logits
output.  A call served by a graph copies the caller's tokens and cache into
the static inputs, replays, copies the new cache back into the caller's
tensors and returns a copy of the logits: callers keep each step's logits,
and the next replay overwrites the static ones.

A prefill's eager body ``body(params, batch) -> (logits, cache)`` returns
new tensors.  Its graph has static inputs (every tensor of the batch) and
static outputs (the logits and every cache tensor).  A call served by a
graph copies the caller's batch into the static inputs, replays and returns
copies of the outputs: a router keeps each prefill's cache, and the next
replay overwrites the static ones.

A graph engages only where the input shows that it is safe: autograd off;
the tokens, every other input and every parameter leaf a plain
``torch.Tensor`` (no DTensor: the tensor-parallel path stays eager) on one
CUDA device; the current stream not capturing; no Python dispatch mode
active (the dry run's cost trace has to see every operation).  Anything
else runs ``body`` as it is: the CPU, the meta device, DTensors.

A graph is keyed by the layout (device, inference mode, each input's name,
shape and dtype) and holds the ``params`` object it was captured with,
compared by identity: another ``params`` object recaptures.  It reads its
weights' storage at every replay, so weights updated in place are read by
the next replay.  A leaf replaced by another tensor in the same ``params``
object is not seen: the graph keeps reading the leaf it captured (and
holds it alive).  At most :data:`KEEP` graphs of a kind live at once a
model.  When a layout is captured differs by kind, since a capture costs
about as much as seven eager 4k prefills:

- decode: at its first call, in place of the least recently used graph
  (dropped with its memory pool) once :data:`KEEP` are kept.  A request
  runs its decode step many times in a row, so the capture pays at once.
- prefill: at its second call, and only into a free place or the place of
  a graph captured for another ``params`` object; else the eager body
  runs.  A request prefills once: a layout seen once may never recur, and
  a graph that is still replayed, evicted for another layout, would be
  captured again in turn.  So the graphs kept are those of the first
  :data:`KEEP` layouts that recur (among the last :data:`SEEN` new ones),
  and a stream of any mix of lengths pays for at most :data:`KEEP`
  captures a ``params`` object, the rest of it at the eager body's speed.

Counters (``repro_torch.tracing``), ``<kind>`` ``decode`` or ``prefill``:
``<kind>.graph_captures`` counts a call that captured (it warms ``body`` on
a side stream, captures, and replays once for its own result),
``<kind>.graph_replays`` a call served by an existing graph, and
``decode.eager_steps`` / ``prefill.eager_runs`` a call that ran ``body`` on
a CUDA device.  ``n`` decode steps of one layout count one capture and
``n - 1`` replays; ``n`` prefills of one layout one eager run, one capture
and ``n - 2`` replays.  The kernels' launch counters (every ``LAUNCHES`` of
``kernels.LAUNCH_COUNTERS``) count, for every call a graph serves, the
launches that one run of ``body`` makes: the capture's own count, added
again at each replay; the warm-ups count none.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import kernels, tracing
from repro_torch.tree import tree_leaves

#: eager runs of the body on a side stream before a capture
#: (``torch.cuda.graphs`` asks for a few: lazy initialisation, such as
#: cuBLAS's handles and workspaces, must not happen inside the capture)
WARMUP = 3
#: graphs of a kind kept a model (a layout served, and one more)
KEEP = 2
#: new prefill layouts remembered a model, the oldest forgotten first: a
#: layout that recurs only after more new ones than this runs eagerly
#: again at its return
SEEN = 64

Inputs = Dict[str, Any]


class _Graph:
    """One captured step: its graph, the ``params`` it read and their
    leaves (held alive), its static inputs and outputs, and the kernel
    launches one run of the body counted (each launch counter with what
    it gained)."""
    __slots__ = ("graph", "params", "leaves", "inputs", "outputs",
                 "launches")


class StepGraphs:
    """A model's captured graphs of one kind of step, at most :data:`KEEP`
    of them, the most recently used last; counted under ``captures``,
    ``replays`` and ``eager``.  ``patient``: a layout is captured at its
    second call and evicts no graph of the same ``params`` (the prefill's
    rule); else at its first, evicting the least recently used (the
    decode step's; module docstring)."""

    def __init__(self, captures: str, replays: str, eager: str,
                 patient: bool):
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()
        self._seen: "OrderedDict[Tuple, None]" = OrderedDict()
        self._captures, self._replays, self._eager = captures, replays, eager
        self._patient = patient

    def replay(self, params, inputs: Inputs,
               run: Callable[[Inputs], Any]) -> Optional[_Graph]:
        """Copy ``inputs`` (``tokens`` among them) into the static inputs of
        their layout's graph and replay it, capturing it first where the
        rule above says so (``run(static inputs)`` runs the body and
        returns its static outputs); the graph, whose ``outputs`` hold the
        results.  None where no graph runs these inputs: the caller runs
        the body eagerly (counted here)."""
        key = _layout(inputs)
        if key is None:
            return self._ran_eager(inputs)
        g = self._graphs.get(key)
        if g is not None and g.params is params:
            self._graphs.move_to_end(key)
            tracing.count(self._replays)
        else:
            leaves = tree_leaves(params)
            if not all(_plain(t, inputs["tokens"].device) for t in leaves) \
                    or not self._admit(key, params):
                return self._ran_eager(inputs)
            g = self._capture(key, params, leaves, inputs, run)
            tracing.count(self._captures)
        for name, t in inputs.items():
            g.inputs[name].copy_(t)
        g.graph.replay()
        for counter, gained in g.launches:
            for name, n in gained.items():
                counter[name] += n
        return g

    def _admit(self, key: Tuple, params) -> bool:
        """Whether layout ``key``, which no graph of ``params`` serves, is
        captured now; makes room for its graph where it is."""
        if self._graphs.pop(key, None) is not None:   # the old params'
            return True
        if not self._patient:
            while len(self._graphs) >= KEEP:
                self._graphs.popitem(last=False)
            return True
        if key not in self._seen:                     # its first call
            self._seen[key] = None
            if len(self._seen) > SEEN:
                self._seen.popitem(last=False)
            return False
        if len(self._graphs) >= KEEP:
            dead = [k for k, g in self._graphs.items()
                    if g.params is not params]
            if not dead:
                return False
            del self._graphs[dead[0]]
        del self._seen[key]
        return True

    def _ran_eager(self, inputs: Inputs) -> None:
        """Count an eager run where the tokens are on a CUDA device; None,
        the caller's sign to run the body."""
        tokens = inputs["tokens"]
        if isinstance(tokens, torch.Tensor) and tokens.is_cuda:
            tracing.count(self._eager)

    def _capture(self, key: Tuple, params, leaves: List[torch.Tensor],
                 inputs: Inputs, run: Callable[[Inputs], Any]) -> _Graph:
        """Capture ``run`` over new static buffers of ``inputs``' layout;
        the caller's tensors are not touched, and the kernels' launch
        counters are left as they were."""
        g = _Graph()
        g.params, g.leaves = params, leaves
        g.inputs = {name: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                    for name, t in inputs.items()}
        before = [(c, dict(c)) for c in kernels.LAUNCH_COUNTERS]
        dev = inputs["tokens"].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                run(g.inputs)
        main.wait_stream(side)
        warm = [(c, dict(c)) for c in kernels.LAUNCH_COUNTERS]
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph):
            g.outputs = run(g.inputs)
        g.launches = [(c, {name: n - w[name] for name, n in c.items()
                           if n > w[name]}) for c, w in warm]
        g.launches = [(c, gained) for c, gained in g.launches if gained]
        for c, b in before:
            c.update(b)
        self._graphs[key] = g
        return g


class DecodeGraphs(StepGraphs):
    """A model's captured decode steps (counters ``decode.*``)."""

    def __init__(self):
        super().__init__("decode.graph_captures", "decode.graph_replays",
                         "decode.eager_steps", patient=False)

    def __call__(self, body: Callable, params, cache: Dict[str, Any],
                 tokens) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``body(params, cache, tokens)``, through a graph where the inputs
        allow one."""
        g = self.replay(params, {"tokens": tokens, **cache},
                        lambda s: body(params, {name: s[name]
                                                for name in cache},
                                       s["tokens"])[0])
        if g is None:
            return body(params, cache, tokens)
        for name, t in cache.items():
            t.copy_(g.inputs[name])
        return g.outputs.clone(), cache


class PrefillGraphs(StepGraphs):
    """A model's captured prefills (counters ``prefill.*``)."""

    def __init__(self):
        super().__init__("prefill.graph_captures", "prefill.graph_replays",
                         "prefill.eager_runs", patient=True)

    def __call__(self, body: Callable, params, batch: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``body(params, batch)``, through a graph where the inputs allow
        one; the logits and cache returned are new tensors either way."""
        g = self.replay(params, batch, lambda s: body(params, s))
        if g is None:
            return body(params, batch)
        logits, cache = g.outputs
        return logits.clone(), {name: t.clone() for name, t in cache.items()}


def _plain(t, device: torch.device) -> bool:
    return type(t) is torch.Tensor and t.device == device


def _layout(inputs: Inputs) -> Optional[Tuple]:
    """The key of the graph for these inputs, or None where no graph may
    run them (module docstring)."""
    if torch.is_grad_enabled() or _get_current_dispatch_mode() is not None:
        return None
    tokens = inputs["tokens"]
    if type(tokens) is not torch.Tensor or not tokens.is_cuda or \
            torch.cuda.is_current_stream_capturing():
        return None
    dev = tokens.device
    key = [dev, torch.is_inference_mode_enabled()]
    for name, t in inputs.items():
        if not _plain(t, dev):
            return None
        key.append((name, t.shape, t.dtype))
    return tuple(key)
