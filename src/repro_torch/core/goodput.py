"""Goodput accounting, as defined by the paper.

    "Goodput is short for 'good throughput', which in training systems is the
    rate of good or effective training progress. For example, we might report
    a training throughput of X for a system in normal operation, but if the
    system spends 10% of its total time recovering from errors or failures,
    then the goodput would be 0.9X."

The ledger tracks wall time partitioned into productive step time, wasted
rework (steps lost since the last checkpoint), failure detection time, and
restart/restore overhead. It is fed by the trainer (real measured intervals)
or by the resilience simulator (modeled intervals) — both report
``goodput = productive / total``, comparable to the paper's Gemini numbers
(97% on TPU v4 [Gemini23], 93% multi-pod on TPU v5p [Gemini25]).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class GoodputEvent:
    kind: str  # "steps" | "rework" | "detect" | "restore" | "idle"
    seconds: float
    steps: int = 0
    note: str = ""


@dataclasses.dataclass
class GoodputLedger:
    events: List[GoodputEvent] = dataclasses.field(default_factory=list)

    # -- recording -----------------------------------------------------------

    def record_steps(self, seconds: float, steps: int, note: str = "") -> None:
        self._record("steps", seconds, steps, note)

    def record_rework(self, seconds: float, steps: int, note: str = "") -> None:
        """Steps re-executed after restore (lost progress since checkpoint)."""
        self._record("rework", seconds, steps, note)

    def record_detection(self, seconds: float, note: str = "") -> None:
        self._record("detect", seconds, 0, note)

    def record_restore(self, seconds: float, note: str = "") -> None:
        self._record("restore", seconds, 0, note)

    def record_idle(self, seconds: float, note: str = "") -> None:
        self._record("idle", seconds, 0, note)

    def _record(self, kind: str, seconds: float, steps: int, note: str) -> None:
        if seconds < 0:
            raise ValueError("negative duration")
        self.events.append(GoodputEvent(kind, seconds, steps, note))

    # -- reporting -----------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0.0) + e.seconds
        return out

    @property
    def total_seconds(self) -> float:
        return sum(e.seconds for e in self.events)

    @property
    def productive_seconds(self) -> float:
        return sum(e.seconds for e in self.events if e.kind == "steps")

    @property
    def goodput(self) -> float:
        tot = self.total_seconds
        return self.productive_seconds / tot if tot > 0 else 1.0

    @property
    def effective_steps(self) -> int:
        return sum(e.steps for e in self.events if e.kind == "steps")

    def structure(self) -> List[Tuple[str, int]]:
        """The ledger as a (kind, steps) sequence with consecutive
        same-kind events merged.

        Durations are dropped: a *measured* ledger (ResilientTrainer) and
        a *modeled* one (fleet simulator) driven by the same failure plan
        must agree on this sequence event-for-event even though their
        seconds differ — the fleet bridge pins exactly that."""
        out: List[Tuple[str, int]] = []
        for e in self.events:
            if out and out[-1][0] == e.kind:
                out[-1] = (e.kind, out[-1][1] + e.steps)
            else:
                out.append((e.kind, e.steps))
        return out

    def summary(self) -> Dict[str, float]:
        t = self.totals()
        return {
            "goodput": self.goodput,
            "total_s": self.total_seconds,
            "productive_s": t.get("steps", 0.0),
            "rework_s": t.get("rework", 0.0),
            "detect_s": t.get("detect", 0.0),
            "restore_s": t.get("restore", 0.0),
            "idle_s": t.get("idle", 0.0),
            "effective_steps": float(self.effective_steps),
        }


def modeled_goodput(
    *,
    mtbf_hours: float,
    detect_s: float,
    restore_s: float,
    checkpoint_interval_s: float,
    checkpoint_write_s: float = 0.0,
) -> float:
    """Closed-form expected goodput for a synchronous job.

    Per failure (rate lambda = 1/MTBF) we lose: detection + restore + on
    average half a checkpoint interval of rework. Checkpoint writes that
    block training cost checkpoint_write_s per interval (0 if async).
    """
    lam = 1.0 / (mtbf_hours * 3600.0)
    loss_per_failure = detect_s + restore_s + 0.5 * checkpoint_interval_s
    overhead = lam * loss_per_failure + checkpoint_write_s / checkpoint_interval_s
    return 1.0 / (1.0 + overhead)
