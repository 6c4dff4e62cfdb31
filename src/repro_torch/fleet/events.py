"""Deterministic discrete-event engine for the fleet simulator.

A seeded event heap and nothing else: no wall clock, no threads. Ties in
time break by insertion order (a monotonically increasing sequence
number), so two runs with the same seed and the same schedule calls pop
the exact same event sequence — the determinism property the fleet tests
pin (and that the elastic re-scale arm inherits: same seed, same
shrink/grow-back sequence). Stochastic arrivals (failures, corruptions)
draw from the engine's ``rng``; callers that want a purely deterministic
timeline simply never touch it.

The simulator's event vocabulary rides this engine unchanged: arrival /
complete / cube_fail / plan_fail / repair / sdc_corrupt / sdc_detect,
plus ``ckpt_write`` (synchronous snapshot stalls) and ``install``
(incremental-deployment waypoints). Stale timelines are invalidated by
per-job epochs, not cancellation, so the heap may hold superseded
events; ``cancel`` exists for the few cases (SDC map-out) that must
retract a pending failure.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence. ``payload`` is owned by the scheduler's
    handler; ``seq`` is the deterministic tiebreaker and identity."""

    time: float
    seq: int
    kind: str
    payload: Dict[str, Any]

    def __getitem__(self, key: str) -> Any:
        return self.payload[key]


class EventEngine:
    def __init__(self, seed: int = 0):
        self.now = 0.0
        self.rng = np.random.default_rng(seed)
        self._heap: List[tuple] = []
        self._seq = 0
        self._cancelled: set = set()
        self.processed = 0

    # -- scheduling ----------------------------------------------------------

    def schedule_at(self, time: float, kind: str, **payload: Any) -> Event:
        if time < self.now:
            raise ValueError(
                f"cannot schedule {kind!r} at {time} < now {self.now}")
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   payload=payload)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def schedule(self, delay: float, kind: str, **payload: Any) -> Event:
        return self.schedule_at(self.now + max(0.0, delay), kind, **payload)

    def cancel(self, ev: Event) -> None:
        self._cancelled.add(ev.seq)

    def draw_exponential(self, mean: float) -> float:
        return float(self.rng.exponential(mean))

    # -- draining ------------------------------------------------------------

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][1] in self._cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[Event]:
        """Next live event, advancing ``now`` to its time."""
        while self._heap:
            _, seq, ev = heapq.heappop(self._heap)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self.now = ev.time
            self.processed += 1
            return ev
        return None

    def drain_until(self, until: float) -> Iterator[Event]:
        """Yield events with time <= until (advancing ``now``); events
        beyond the horizon stay queued. Finally advances ``now`` to
        ``until``."""
        while True:
            t = self.peek_time()
            if t is None or t > until:
                break
            ev = self.pop()
            assert ev is not None
            yield ev
        self.now = max(self.now, until)
