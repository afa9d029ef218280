"""Client-side estimation of the positive-indication ratio q_j (Eq. 9).

Epochs of T requests; within epoch i the estimate is frozen at the value
computed at the end of epoch i-1; at each epoch boundary:

    q <- delta * (a / T) + (1 - delta) * q          (Eq. 9)

where ``a`` counts positive indications observed during the epoch.  Only
the client can do this — it sees every request, not just accessed caches.
"""
from __future__ import annotations

import numpy as np


class QEstimator:
    def __init__(self, horizon: int = 100, delta: float = 0.25, q0: float = 0.5):
        if int(horizon) < 1:
            # horizon <= 0 would make observe() close an epoch on a zero
            # count (ZeroDivisionError) and observe_batch() loop forever
            raise ValueError(
                f"QEstimator horizon must be a positive epoch length, "
                f"got {horizon!r}")
        self.horizon = int(horizon)
        self.delta = float(delta)
        self.q = float(q0)
        self.version = 0  # bumped at every epoch boundary (cache invalidation)
        self._count = 0
        self._positives = 0
        self._bootstrapped = False

    def _close_epoch(self) -> None:
        frac = self._positives / self._count
        if not self._bootstrapped:
            # first epoch: raw average (q_{j,t} = a(0,t)/t for t <= T)
            self.q = frac
            self._bootstrapped = True
        else:
            self.q = self.delta * frac + (1.0 - self.delta) * self.q
        self.version += 1
        self._count = 0
        self._positives = 0

    def observe(self, indication: bool) -> None:
        self._count += 1
        self._positives += int(indication)
        if self._count >= self.horizon:
            self._close_epoch()

    def observe_batch(self, indications: np.ndarray) -> int:
        """Consume a slice of indications at once (simulator fast engine).

        Bit-exact with calling :meth:`observe` per element: the positive
        counter is an integer, so within-epoch summation order is
        irrelevant, and each completed epoch applies exactly the Eq. (9)
        update the scalar path would.  Returns the number of epoch
        boundaries crossed (each also bumped :attr:`version`).
        """
        a = np.asarray(indications, dtype=bool)
        crossed, i, total = 0, 0, int(a.shape[0])
        while i < total:
            take = min(self.horizon - self._count, total - i)
            self._positives += int(np.count_nonzero(a[i:i + take]))
            self._count += take
            i += take
            if self._count >= self.horizon:
                self._close_epoch()
                crossed += 1
        return crossed

    @property
    def value(self) -> float:
        return self.q


def ewma_path(e0: float, outcomes: np.ndarray, gamma: float) -> np.ndarray:
    """Exact trajectory of the probe-feedback EWMA ``e <- (1-g)e + g a``.

    ``outcomes`` are the {0, 1} probe results in arrival order; returns the
    value AFTER each update, as float64.  The recurrence is applied one
    scalar IEEE multiply-add at a time — i.e. it IS the reference loop's
    update, so the returned path is bit-identical to updating per probe
    (unlike an ``exp/cumsum`` closed form, whose rounding differs).  The
    simulator's calibrated fast engine uses this to advance a whole
    speculation segment's EWMA state in one call per (cache, branch).
    """
    a = np.asarray(outcomes, dtype=np.float64)
    out = np.empty(a.shape[0], dtype=np.float64)
    e = float(e0)
    g = float(gamma)
    for t, av in enumerate(a.tolist()):
        e = (1.0 - g) * e + g * av
        out[t] = e
    return out


class WindowedRatio:
    """Plain windowed ratio (used for measured FN/hit-rate reporting)."""

    def __init__(self):
        self.num = 0
        self.den = 0

    def observe(self, hit: bool) -> None:
        self.num += int(hit)
        self.den += 1

    @property
    def value(self) -> float:
        return self.num / self.den if self.den else 0.0
