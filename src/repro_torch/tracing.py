"""The port's span recorder: where a request's time goes inside the
program, on the clock of ``torch.profiler``'s device trace.

Off by default.  While off, :func:`span` returns one shared no-op context
after a single global check, so the instrumented serving path pays a
function call and nothing else.  While on, each span keeps its name, its
own id, the id of the span open when it started (its parent), the
request it belongs to and its start and end in nanoseconds.

Times are ``time.time_ns()``: the epoch clock on which ``torch.profiler``
stamps its kineto events (a ``record_function`` opened right after a
``time.time_ns()`` read starts right after it), so a recorded span lies on
the device timeline of a profile taken at the same time with no offset to
fit.

A span that passes ``request`` starts a request: it and every span after
it, up to the next span that passes one, carry that id.  The server
handles one request at a time on one thread, so spans nest as a stack;
callers that share the program between threads serialise their requests
(``serving.replay`` holds a lock around each).

Spans are kept in memory: :func:`enable`, :func:`disable`, :func:`clear`
and :func:`spans` control and read them, and :func:`write` stores them as
Chrome-trace JSON, which Perfetto opens beside the profiler's own export.

The spans of the serving path: ``route`` (``PrefixServeCluster.request``;
it starts a request, its id ``RouteStats.requests`` at its start),
``prefill`` (``ServeEngine.prefill``, inside ``route`` on a miss; it ends
when the launches are enqueued, since the program does not synchronise
and its caller does), ``decode`` (``ServeEngine.decode``, the cache's copy
included) and ``decode.step`` (each decode iteration: the model's step,
the sampling and the token's copy to the host, a synchronisation).  The
published Zamba2 block (``models.zamba2_published``) adds
``shared_block``, each application of a shared block, in prefill and in
decode.

Counters are process-wide integers, always on (an add against a step of
a millisecond or more): :func:`count` adds to one, :func:`counters` reads
them all and :func:`reset_counters` zeroes them.  The serving path's:
``decode.graph_captures`` (a decode step that captured its layout's CUDA
graph), ``decode.graph_replays`` (a step that replayed one) and
``decode.eager_steps`` (a step that ran the eager body on a CUDA device),
all counted by ``models.decode_graph.DecodeGraphs``; their prefill twins
``prefill.graph_captures``, ``prefill.graph_replays`` and
``prefill.eager_runs``, counted by ``models.decode_graph.PrefillGraphs``
(``Mamba2LM.prefill``); and the published
Zamba2 block's (``models.zamba2_published``): ``hybrid.shared_apps``
(applications of a shared block where its code runs: a graph's replay
runs none), ``hybrid.prefills`` (prefills), and the bytes of the caches
those prefills return, ``hybrid.prefix_kv_bytes`` (K/V) and
``hybrid.prefix_state_bytes`` (SSD state and conv history).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None     # None while the span is open


class _Noop:
    """The context :func:`span` returns while the recorder is off.  Its
    two methods are C callables, so entering and leaving it runs no Python
    frame: ``NoneType()`` gives None to ``as``, and ``"".format(*exc_info)``
    gives "", which is false, so an exception passes through."""
    __slots__ = ()
    __enter__ = staticmethod(type(None))
    __exit__ = staticmethod("".format)


NOOP = _Noop()

_on = False
_spans: List[Span] = []        # in the order they started
_stack: List[Span] = []        # the spans open now
_request: Optional[int] = None
_counters: Dict[str, int] = {}


class _Open:
    """One span being recorded."""
    __slots__ = ("name", "request", "span")

    def __init__(self, name: str, request: Optional[int]):
        self.name, self.request = name, request

    def __enter__(self):
        global _request
        if self.request is not None:
            _request = self.request
        parent = _stack[-1].id if _stack else None
        self.span = Span(self.name, len(_spans), parent, _request,
                         time.time_ns())
        _spans.append(self.span)
        _stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.span.end_ns = time.time_ns()
        if _stack and _stack[-1] is self.span:
            _stack.pop()
        return None


def span(name: str, request: Optional[int] = None):
    """A context that records span ``name`` while the recorder is on (and
    does nothing while it is off); ``request`` starts a request."""
    if not _on:
        return NOOP
    return _Open(name, request)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def clear() -> None:
    """Drop the recorded spans."""
    global _request
    _spans.clear()
    _stack.clear()
    _request = None


def spans() -> List[Span]:
    """The recorded spans, in the order they started."""
    return list(_spans)


def write(path) -> int:
    """Write the finished spans to ``path`` as Chrome-trace JSON (complete
    events in microseconds on the epoch clock, each with its id, parent and
    request under ``args``); returns how many."""
    done = [s for s in _spans if s.end_ns is not None]
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "pid": pid, "tid": pid,
               "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"id": s.id, "parent": s.parent,
                        "request": s.request}}
              for s in done]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter counted since the last reset."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()
