"""Fault tolerance: preemption handling, straggler detection, elastic
meshes — the port of the JAX package's ``repro.distributed.ft``.

* :class:`PreemptionHandler` — SIGTERM/SIGUSR1 -> "checkpoint and exit 42"
  (the restart contract cluster schedulers expect; the launcher is
  re-invoked with ``--resume``).
* :class:`StepTimer` — EMA/variance step-time tracker flagging
  stragglers.
* :func:`elastic_mesh` — the largest usable (data, model) mesh over the
  ranks that are live now: the model dim fixed (the weights must fit),
  the data dim the largest power of two <= live / model_dim.  With
  ``checkpoint.restore(shardings=...)`` this is the elastic restart: lose
  a host, start a smaller world, rebuild the mesh, reshard, continue.
  Ranks beyond data x model_dim are spare: they hold no part of the mesh
  (``is_spare``) — the launcher has them wait at a barrier for the run's
  end and exit 0.
"""
from __future__ import annotations

import math
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import make_mesh, world_size


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


def elastic_mesh(model_dim: int = 1, ranks: Optional[Sequence[int]] = None
                 ) -> DeviceMesh:
    """Largest (data, model) mesh over the live ranks (``ranks``, the
    whole world by default): data = floor(live / model_dim) rounded down
    to a power of two so batch sharding stays divisible.  Collective:
    every rank of the world calls it, spare ones too."""
    ranks = list(range(world_size())) if ranks is None else list(ranks)
    live = len(ranks)
    if live < model_dim:
        raise RuntimeError(f"only {live} ranks live; need >= "
                           f"model_dim={model_dim}")
    data = live // model_dim
    data = 2 ** int(math.log2(data)) if data > 0 else 1
    n = data * model_dim
    return make_mesh((data, model_dim), ("data", "model"), ranks=ranks[:n])


def is_spare(mesh: DeviceMesh) -> bool:
    """Whether this rank lies outside ``mesh``."""
    return mesh.get_coordinate() is None
