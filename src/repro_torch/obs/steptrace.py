"""Measured step-time traces: the replayable artifact between real
runs and the fleet simulator.

A ``StepTrace`` records one event per executed unit of work — a train
step, a decode chunk, a prefill — with its measured wall duration and
a small feature dict (batch size, token counts, prefix-hit, chunk
kind). ``fleet.perf.StepTimeModel.from_trace`` turns the artifact into
a step-time model, so the simulator can run on measured serve/train
traces instead of the analytic roofline (ROADMAP item 3), and every
future kernel PR gets a predicted-vs-measured seam.

Serialization is a plain JSON document (``SCHEMA`` below) so traces
survive process boundaries — the tier-1 gate records one in the serve
smoke subprocess and replays it through the sim in another.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

SCHEMA = "repro.obs.steptrace/v1"

# Pinned event kinds. "step"/"decode"/"spec_decode" are effective work
# (what a step-time model should learn from); "replay" is rework after
# a restore; "prefill"/"ckpt" are role-specific phases.
KINDS = ("step", "replay", "prefill", "decode", "spec_decode", "ckpt")

# The kinds from_trace treats as one effective step by default.
EFFECTIVE_KINDS = ("step", "decode", "spec_decode")


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One executed unit of work with its measured duration."""

    kind: str
    duration_s: float
    features: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "duration_s": self.duration_s,
                "features": dict(self.features)}


class StepTrace:
    """Append-only measured trace from one source ("serve"/"train")."""

    def __init__(self, source: str = "",
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.source = source
        self.meta: Dict[str, Any] = dict(meta or {})
        self.events: List[StepEvent] = []

    def record(self, kind: str, duration_s: float,
               **features: float) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown step kind {kind!r}; "
                             f"pinned kinds: {KINDS}")
        self.events.append(StepEvent(
            kind=kind, duration_s=float(duration_s),
            features={k: float(v) for k, v in features.items()}))

    def durations(self, kinds: Optional[Sequence[str]] = None
                  ) -> List[float]:
        """Durations filtered to ``kinds`` (default: every event)."""
        if kinds is None:
            return [e.duration_s for e in self.events]
        kindset = set(kinds)
        return [e.duration_s for e in self.events if e.kind in kindset]

    def mean_duration_s(self, kinds: Optional[Sequence[str]] = None
                        ) -> float:
        ds = self.durations(kinds)
        return sum(ds) / len(ds) if ds else 0.0

    def feature_values(self, name: str,
                       kinds: Optional[Sequence[str]] = None,
                       default: float = 0.0) -> List[float]:
        """One feature column across events, filtered to ``kinds``.

        Parallel to ``durations(kinds)`` — same events, same order — so
        calibration fits (``fleet.perf.service_model_from_trace``) can
        zip feature columns against measured durations."""
        if kinds is None:
            return [e.features.get(name, default) for e in self.events]
        kindset = set(kinds)
        return [e.features.get(name, default) for e in self.events
                if e.kind in kindset]

    def __len__(self) -> int:
        return len(self.events)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": SCHEMA, "source": self.source,
                "meta": dict(self.meta),
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "StepTrace":
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"not a steptrace document: "
                             f"schema={doc.get('schema')!r}")
        tr = cls(source=doc.get("source", ""), meta=doc.get("meta"))
        for e in doc.get("events", []):
            tr.events.append(StepEvent(
                kind=e["kind"], duration_s=float(e["duration_s"]),
                features={k: float(v)
                          for k, v in e.get("features", {}).items()}))
        return tr

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def read(cls, path: str) -> "StepTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))
