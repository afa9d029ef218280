"""The device trace of a run's traced slice (``torch.profiler``, CPU and
CUDA activities), reduced to what the metric readers and the result's
``breakdown`` need: the device operations with their times, the seconds in
which some operation ran on the device, and the idle gaps labelled by
what the host was doing in them (the benchmark's own phase span around
the program's call, and the innermost host operation running at the
gap's middle)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: the benchmark's spans in the trace (``torch.profiler.record_function``)
PHASES = ("bench.route", "bench.prefill", "bench.decode")
#: the span around the whole traced slice: the traced window
SLICE = "bench.slice"

Span = Tuple[float, float, str]


@dataclass
class DeviceTrace:
    """Device operations as (name, start s, seconds) in the traced window
    [0, ``window_s``]; the host's operations and the benchmark's phase
    spans as (start s, end s, name), each sorted by start."""
    ops: List[Tuple[str, float, float]]
    window_s: float
    host: List[Span] = field(default_factory=list)
    phases: List[Span] = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return self.window_s - sum(d for _, d in self.gaps())

    def gaps(self) -> List[Tuple[float, float]]:
        """(start, seconds) of each interval of the window with no device
        operation, in order."""
        out, end = [], 0.0
        for _, t0, dur in sorted(self.ops, key=lambda o: o[1]):
            if t0 > end:
                out.append((end, t0 - end))
            end = max(end, t0 + dur)
        if self.window_s > end:
            out.append((end, self.window_s - end))
        return out

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """{device operation: (calls, seconds)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, _, dur in self.ops:
            n, s = out.get(name, (0, 0.0))
            out[name] = (n + 1, s + dur)
        return out

    def labels(self, times: List[float]) -> List[str]:
        """What the host was doing at each of the ascending ``times``: its
        phase span and the innermost host operation running, e.g.
        ``bench.decode/aten::mm``.  One sweep over the nested spans: a
        stack holds those open at the current time."""
        def inner(spans):
            out, stack, i = [], [], 0
            for t in times:
                while i < len(spans) and spans[i][0] <= t:
                    while stack and stack[-1][1] <= spans[i][0]:
                        stack.pop()
                    stack.append(spans[i])
                    i += 1
                while stack and stack[-1][1] <= t:
                    stack.pop()
                out.append(stack[-1][2] if stack else "")
            return out
        phase, op = inner(self.phases), inner(self.host)
        return [f"{p or 'client'}/{o}" if o else (p or "client")
                for p, o in zip(phase, op)]

    def breakdown(self, top: int = 10) -> Dict[str, List[list]]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:top]
        gaps = self.gaps()
        idle: Dict[str, float] = {}
        for lab, (_, dur) in zip(self.labels([t + d / 2 for t, d in gaps]),
                                 gaps):
            idle[lab] = idle.get(lab, 0.0) + dur
        worst = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in worst]}


def _events(prof):
    """(name, on the device, start ns, duration ns, thread) of every
    event, from the profiler's raw records (building its function events
    would take minutes for a slice of many eager decode steps)."""
    from torch.autograd import DeviceType
    for ev in prof.profiler.kineto_results.events():
        yield (ev.name(), ev.device_type() != DeviceType.CPU,
               ev.start_ns(), ev.duration_ns(), ev.start_thread_id())


def from_profile(prof) -> DeviceTrace:
    """A :class:`DeviceTrace` of a finished ``torch.profiler.profile``
    around a ``bench.slice`` span, the traced window (none without it).
    Host spans are those of the thread that opened the slice (one
    thread's spans nest)."""
    dev, host = [], []
    for name, on_dev, start, dur, thread in _events(prof):
        if on_dev:
            # a span's copy on the device's timeline is no operation
            if name not in PHASES and name != SLICE:
                dev.append((name, start, dur))
        else:
            host.append((start, start + dur, name, thread))
    window = [(a, b, th) for a, b, n, th in host if n == SLICE]
    if not window:
        return DeviceTrace([], 0.0)
    t0, t1, main = window[0]
    host = [h for h in host if h[3] == main]
    ops = [(n, (s - t0) * 1e-9, d * 1e-9) for n, s, d in dev if t0 <= s < t1]
    spans = sorted(((a - t0) * 1e-9, (b - t0) * 1e-9, n)
                   for a, b, n, _ in host if n != SLICE)
    return DeviceTrace(ops, (t1 - t0) * 1e-9,
                       [s for s in spans if s[2] not in PHASES],
                       [s for s in spans if s[2] in PHASES])
