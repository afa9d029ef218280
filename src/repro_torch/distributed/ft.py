"""Fault tolerance: preemption handling and straggler detection — the
port of the JAX package's ``repro.distributed.ft`` (``elastic_mesh``
waits for the device mesh, ROADMAP A8 item 6).

* :class:`PreemptionHandler` — SIGTERM/SIGUSR1 -> "checkpoint and exit 42"
  (the restart contract cluster schedulers expect; the launcher is
  re-invoked with ``--resume``).
* :class:`StepTimer` — EMA/variance step-time tracker flagging
  stragglers.
"""
from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self._flag = threading.Event()
        self._installed = False
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        if not self._installed:
            for s in self._signals:
                try:
                    signal.signal(s, self._on_signal)
                except ValueError:  # non-main thread (tests)
                    pass
            self._installed = True
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()

    def trigger(self) -> None:  # for tests / manual drills
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


@dataclass
class StepTimer:
    """EMA step-time straggler detector."""
    alpha: float = 0.1
    threshold: float = 2.0     # x mean => straggler
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    stragglers: List[int] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(step, dt)
        return dt

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # seed the EMA
            self.mean = dt if self.n == 1 else (self.mean + dt) / 2
            return False
        is_straggler = dt > self.threshold * max(self.mean, 1e-9)
        if is_straggler:
            self.stragglers.append(step)
        # straggler steps don't poison the EMA
        w = self.alpha if not is_straggler else self.alpha * 0.1
        self.var = (1 - w) * self.var + w * (dt - self.mean) ** 2
        self.mean = (1 - w) * self.mean + w * dt
        return is_straggler
