"""Fault tolerance: heartbeat monitoring and the serving watchdog
(``repro.train.fault``'s ``HeartbeatMonitor`` and ``WorkerWatchdog``).

* :class:`HeartbeatMonitor` -- per-step wall-time records per worker; a
  worker is flagged a straggler when its trailing-window median exceeds
  ``threshold`` x the fleet median, and dead when it misses
  ``miss_limit`` heartbeats.
* :class:`WorkerWatchdog` -- the serving tiers' monitor: a per-worker EWMA
  step time, and death on the worker's own clock.

Host code only; the reference's ``ElasticPolicy`` comes with training.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Dict, List

__all__ = ["HeartbeatMonitor", "WorkerWatchdog", "StragglerReport"]


@dataclasses.dataclass
class StragglerReport:
    step: int
    stragglers: List[str]
    dead: List[str]
    fleet_median_s: float
    worker_medians: Dict[str, float]


class HeartbeatMonitor:
    def __init__(self, workers: List[str], window: int = 16,
                 threshold: float = 1.5, miss_limit: int = 3):
        self.workers = list(workers)
        self.window = window
        self.threshold = threshold
        self.miss_limit = miss_limit
        self._times: Dict[str, collections.deque] = {
            w: collections.deque(maxlen=window) for w in self.workers}
        self._last_step: Dict[str, int] = {w: -1 for w in self.workers}
        self._step = -1

    def record(self, worker: str, step: int, duration_s: float) -> None:
        self._times[worker].append(duration_s)
        self._last_step[worker] = step
        self._step = max(self._step, step)

    def report(self) -> StragglerReport:
        medians = {w: (statistics.median(t) if t else float("inf"))
                   for w, t in self._times.items()}
        finite = [m for m in medians.values() if m != float("inf")]
        fleet = statistics.median(finite) if finite else float("inf")
        stragglers = [w for w, m in medians.items()
                      if m != float("inf") and fleet > 0
                      and m > self.threshold * fleet]
        dead = [w for w in self.workers
                if self._step - self._last_step[w] >= self.miss_limit]
        return StragglerReport(self._step, stragglers, dead, fleet, medians)


class WorkerWatchdog(HeartbeatMonitor):
    """Serving-aware extension of :class:`HeartbeatMonitor` for tier
    workers (``repro_torch.serving.AsyncServer``).

    The base monitor's death test counts *missed steps*, which assumes a
    fleet stepping in lockstep — wrong for serving tiers whose step times
    legitimately differ (a quality tier is slower by design).  This
    subclass keeps a per-worker **EWMA step time** and declares a worker
    DEAD on its own clock: no heartbeat for ``miss_limit`` x its EWMA
    step time.  Works identically on the virtual simulation clock and the
    realtime clock — ``now`` is whatever clock the server passes.
    """

    def __init__(self, workers: List[str], window: int = 16,
                 threshold: float = 1.5, miss_limit: int = 3,
                 alpha: float = 0.2):
        super().__init__(workers, window=window, threshold=threshold,
                         miss_limit=miss_limit)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._ewma: Dict[str, float] = {}
        self._last_beat: Dict[str, float] = {}

    def beat(self, worker: str, now: float, duration_s: float) -> None:
        """One completed step: ``now`` is the completion time on the
        server's clock, ``duration_s`` the step's service time."""
        self.record(worker, self._step + 1, duration_s)
        prev = self._ewma.get(worker)
        self._ewma[worker] = duration_s if prev is None else \
            (1.0 - self.alpha) * prev + self.alpha * duration_s
        self._last_beat[worker] = now

    def ewma(self, worker: str) -> float:
        """EWMA step seconds (0.0 before the first beat)."""
        return self._ewma.get(worker, 0.0)

    def overdue(self, worker: str, now: float) -> bool:
        """True when ``worker`` has beaten at least once but is now
        ``miss_limit`` x its EWMA step time past its last heartbeat."""
        last = self._last_beat.get(worker)
        ew = self._ewma.get(worker)
        if last is None or not ew:
            return False
        # >= with an absolute slack so a simulator that jumps its clock
        # exactly to deadline() observes the worker as overdue
        return (now - last) >= self.miss_limit * ew - 1e-12

    def deadline(self, worker: str) -> float:
        """The clock value at which ``worker`` becomes overdue (inf
        before its first beat) — the simulator's next-event candidate."""
        last = self._last_beat.get(worker)
        ew = self._ewma.get(worker)
        if last is None or not ew:
            return float("inf")
        return last + self.miss_limit * ew

    def forget(self, worker: str) -> None:
        """Drop a worker's heartbeat state (revive / fresh run)."""
        self._ewma.pop(worker, None)
        self._last_beat.pop(worker, None)
        self._times[worker].clear()
        self._last_step[worker] = -1
