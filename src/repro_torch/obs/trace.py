"""Span tracing: begin/end spans with pid/tid lanes, an injectable
clock, and Chrome Trace Event Format serialization.

One schema for the whole repo: the fleet simulator's ``TraceRecorder``
(kept API-compatible below, re-exported from ``repro.fleet.trace``),
``ServeEngine`` request lifecycles, and ``ResilientTrainer`` step /
checkpoint / replay events all emit through a ``SpanTracer``, so a
single JSON file loads in chrome://tracing / Perfetto with sim jobs,
serve slots, and trainer steps as sibling process rows.

Timestamps: event methods accept an explicit ``ts`` (seconds — the
fleet sim passes simulated time); when omitted, the injectable
``clock`` is sampled and rebased so the first event sits at t=0.
Stored values follow the Chrome convention (microseconds).

``validate_chrome_trace`` is the tier-1 gate's checker: balanced and
properly nested B/E per (pid, tid) lane, monotonic lane timestamps,
non-negative X durations, required categories present.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

_US = 1e6


class SpanTracer:
    """Chrome-trace event sink with process/thread lanes.

    Disabled tracers record nothing and cost one attribute check per
    call, so hot loops can call unconditionally."""

    def __init__(self, clock=time.monotonic, enabled: bool = True) -> None:
        self.clock = clock
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._open: Dict[Tuple[int, int], List[str]] = {}
        self._t0: Optional[float] = None

    # -- lanes ---------------------------------------------------------------

    def process(self, name: str) -> int:
        """Get-or-register a process row; emits the ``process_name``
        metadata event on first sight. Returns 0 when disabled."""
        if not self.enabled:
            return 0
        if name not in self._pids:
            pid = len(self._pids)
            self._pids[name] = pid
            self.events.append({"ph": "M", "pid": pid,
                                "name": "process_name",
                                "args": {"name": name}})
        return self._pids[name]

    def thread(self, pid: int, tid: int, name: str) -> int:
        """Label a thread lane inside a process row."""
        if self.enabled:
            self.events.append({"ph": "M", "pid": pid, "tid": tid,
                                "name": "thread_name",
                                "args": {"name": name}})
        return tid

    # -- timestamps ----------------------------------------------------------

    def _ts_us(self, ts: Optional[float]) -> float:
        if ts is not None:
            return ts * _US
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        return (now - self._t0) * _US

    # -- emitters ------------------------------------------------------------

    def emit(self, ev: Dict[str, Any]) -> None:
        """Append a pre-built raw event (advanced callers: the fleet
        recorder's colored phases). No-op when disabled."""
        if self.enabled:
            self.events.append(ev)

    def begin(self, name: str, *, pid: int = 0, tid: int = 0,
              cat: str = "", args: Optional[Dict[str, Any]] = None,
              ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"ph": "B", "pid": pid, "tid": tid,
                              "name": name, "ts": self._ts_us(ts)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)
        self._open.setdefault((pid, tid), []).append(name)

    def end(self, *, pid: int = 0, tid: int = 0,
            ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        stack = self._open.get((pid, tid), [])
        name = stack.pop() if stack else "<unmatched>"
        self.events.append({"ph": "E", "pid": pid, "tid": tid,
                            "name": name, "ts": self._ts_us(ts)})

    @contextmanager
    def span(self, name: str, *, pid: int = 0, tid: int = 0,
             cat: str = "", args: Optional[Dict[str, Any]] = None
             ) -> Iterator[None]:
        self.begin(name, pid=pid, tid=tid, cat=cat, args=args)
        try:
            yield
        finally:
            self.end(pid=pid, tid=tid)

    def complete(self, name: str, dur_s: float, *, pid: int = 0,
                 tid: int = 0, cat: str = "",
                 args: Optional[Dict[str, Any]] = None,
                 ts: Optional[float] = None) -> None:
        """An X event; with ``ts`` omitted the span is assumed to end
        now, so its start is rebased ``dur_s`` ago."""
        if not self.enabled:
            return
        if ts is None:
            start_us = self._ts_us(None) - dur_s * _US
        else:
            start_us = ts * _US
        ev: Dict[str, Any] = {"ph": "X", "pid": pid, "tid": tid,
                              "name": name, "ts": start_us,
                              "dur": max(dur_s, 0.0) * _US}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, pid: int = 0, tid: int = 0,
                cat: str = "", scope: str = "g",
                args: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {"ph": "i", "s": scope, "pid": pid,
                              "tid": tid, "name": name,
                              "ts": self._ts_us(ts)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float], *,
                pid: int = 0, tid: int = 0,
                ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.events.append({"ph": "C", "pid": pid, "tid": tid,
                            "name": name, "ts": self._ts_us(ts),
                            "args": dict(values)})

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def validate_chrome_trace(doc: Dict[str, Any],
                          require_cats: Sequence[str] = ()
                          ) -> List[str]:
    """Structural checks on a Chrome-trace document; returns a list of
    problems (empty == valid).

    Checks: every event has ph/pid/name; non-metadata events carry a
    numeric ts; X durations are non-negative; B/E events per (pid, tid)
    lane are balanced, properly nested, and non-decreasing in time;
    every category in ``require_cats`` appears."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[Tuple[int, int], List[Tuple[str, float]]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    cats = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        for field in ("ph", "pid", "name"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if ev.get("cat"):
            cats.add(ev["cat"])
        lane = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')}): "
                                f"X dur {dur!r} not a non-negative number")
        elif ph == "B":
            if ts < last_ts.get(lane, float("-inf")):
                problems.append(f"event {i} ({ev.get('name')}): lane "
                                f"{lane} ts regressed {ts} < "
                                f"{last_ts[lane]}")
            last_ts[lane] = ts
            stacks.setdefault(lane, []).append((ev.get("name", "?"), ts))
        elif ph == "E":
            if ts < last_ts.get(lane, float("-inf")):
                problems.append(f"event {i} ({ev.get('name')}): lane "
                                f"{lane} ts regressed {ts} < "
                                f"{last_ts[lane]}")
            last_ts[lane] = ts
            stack = stacks.get(lane, [])
            if not stack:
                problems.append(f"event {i} ({ev.get('name')}): E "
                                f"without open B on lane {lane}")
            else:
                name, t_open = stack.pop()
                if ts < t_open:
                    problems.append(f"event {i}: span {name!r} on lane "
                                    f"{lane} ends before it begins")
    for lane, stack in stacks.items():
        for name, _ in stack:
            problems.append(f"unclosed span {name!r} on lane {lane}")
    missing = set(require_cats) - cats
    if missing:
        problems.append(f"missing categories: {sorted(missing)} "
                        f"(saw {sorted(cats)})")
    return problems


def merge_chrome_traces(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge trace documents into one timeline, remapping pids so
    process rows from different sources never collide."""
    merged: List[Dict[str, Any]] = []
    base = 0
    for doc in docs:
        events = doc.get("traceEvents", [])
        pids = sorted({e.get("pid", 0) for e in events
                       if isinstance(e, dict)})
        remap = {p: base + i for i, p in enumerate(pids)}
        for ev in events:
            ev2 = dict(ev)
            ev2["pid"] = remap.get(ev.get("pid", 0), base)
            merged.append(ev2)
        base += max(len(pids), 1)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


# -- fleet-sim recorder (re-exported from repro.fleet.trace) -----------------

_POD_PID = 0  # kept for callers that imported the module constant
_PHASE_TID = 1

_COLORS = {
    "train": "good",
    "rework": "bad",
    "restore": "terrible",
    "detect": "yellow",
    "queued": "grey",
    "ckpt": "olive",
}


class TraceRecorder:
    """The fleet simulator's trace surface, now a shim over
    ``SpanTracer``: one process row per job (colored X phases at
    explicit simulated timestamps) plus a pod row of instants and
    counters. Pass a shared tracer to land sim events in the same
    timeline as serve/train spans; the default is a private one, which
    preserves the original standalone behavior byte-for-byte modulo
    metadata-event ordering."""

    def __init__(self, tracer: Optional[SpanTracer] = None) -> None:
        self.tracer = tracer if tracer is not None else SpanTracer()
        self._pod_pid = self.tracer.process("pod")

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self.tracer.events

    def _pid(self, job: str) -> int:
        return self.tracer.process(f"job:{job}")

    def duration(self, job: str, phase: str, t0_s: float, dur_s: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A complete event on the job's row; zero-length phases (async
        checkpoint marks) become instants so they stay visible."""
        ev: Dict[str, Any] = {
            "pid": self._pid(job), "tid": _PHASE_TID, "name": phase,
            "ts": t0_s * _US, "cat": "fleet",
        }
        if _COLORS.get(phase):
            ev["cname"] = _COLORS[phase]
        if args:
            ev["args"] = args
        if dur_s <= 0.0:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=dur_s * _US)
        self.tracer.emit(ev)

    def instant(self, name: str, t_s: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        self.tracer.instant(name, pid=self._pod_pid, tid=0, cat="pod",
                            scope="g", args=args, ts=t_s)

    def counter(self, name: str, t_s: float,
                values: Dict[str, float]) -> None:
        self.tracer.counter(name, values, pid=self._pod_pid, tid=0,
                            ts=t_s)

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        return self.tracer.chrome_trace()

    def write(self, path: str) -> None:
        self.tracer.write(path)
