"""Structured span tracer on the injected serving clock.

``Tracer`` records spans and instants (cache commits, touches, drops,
...) with a monotone per-tracer sequence number; export stable-sorts by
``(ts, seq)`` and serialises with sorted keys, so under a deterministic
clock the exported file is byte-reproducible. The export is the Chrome
trace-event JSON object form, loadable in Perfetto.

``Tracer.disabled`` is a shared no-op singleton that is falsy, so hot
paths guard instrumentation with ``if self.tracer:`` and pay one branch
when tracing is off.

A copy of the in-memory recorder of ``repro.obs.trace``; the streaming
(bounded-memory JSONL) tracer joins with the observability slice.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional

__all__ = ["Tracer", "TraceEvent"]


class TraceEvent:
    """One recorded event (a span when ``dur`` is not None)."""

    __slots__ = ("name", "cat", "ts", "dur", "track", "args", "seq")

    def __init__(self, name, cat, ts, dur, track, args, seq):
        self.name = name
        self.cat = cat
        self.ts = float(ts)
        self.dur = None if dur is None else float(dur)
        self.track = track
        self.args = args
        self.seq = seq


class Tracer:
    """Append-only event recorder with deterministic Chrome export."""

    disabled: "Tracer"  # assigned below (a _DisabledTracer singleton)

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.events: List[TraceEvent] = []
        self.clock = clock       # wall-mode default timestamp source
        self._now = 0.0          # simulated-mode default timestamp
        self._seq = 0

    def __bool__(self) -> bool:
        return True

    def set_time(self, t: float) -> None:
        """Advance the simulated-clock default timestamp."""
        self._now = float(t)

    def now(self) -> float:
        return self.clock() if self.clock is not None else self._now

    def span(self, name: str, cat: str, t0: float, t1: float, *,
             track: str = "engine", **args) -> None:
        """Record a complete span [t0, t1] on ``track``."""
        self._seq += 1
        self.events.append(TraceEvent(name, cat, t0, max(0.0, t1 - t0),
                                      track, args, self._seq))

    def instant(self, name: str, cat: str, at: Optional[float] = None, *,
                track: str = "engine", **args) -> None:
        """Record a point event at ``at`` (default: the tracer clock)."""
        self._seq += 1
        ts = self.now() if at is None else at
        self.events.append(TraceEvent(name, cat, ts, None, track,
                                      args, self._seq))

    def clear(self) -> None:
        self.events.clear()
        self._seq = 0
        self._now = 0.0

    def to_chrome(self, other_data: Optional[dict] = None) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        tracks = sorted({e.track for e in self.events})
        tids = {name: i + 1 for i, name in enumerate(tracks)}
        out = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                "ts": 0, "args": {"name": "EMSServe"}}]
        for name, tid in tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": tid, "ts": 0, "args": {"name": name}})
        for e in sorted(self.events, key=lambda e: (e.ts, e.seq)):
            ev = {
                "name": e.name,
                "cat": e.cat,
                "ph": "X" if e.dur is not None else "i",
                "ts": round(e.ts * 1e6, 3),       # seconds -> microseconds
                "pid": 1,
                "tid": tids[e.track],
                "args": {**e.args, "seq": e.seq},
            }
            if e.dur is not None:
                ev["dur"] = round(e.dur * 1e6, 3)
            else:
                ev["s"] = "t"                      # instant scope: thread
            out.append(ev)
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        if other_data:
            doc["otherData"] = other_data
        return doc

    def export(self, path, other_data: Optional[dict] = None) -> int:
        """Write the Chrome trace JSON to ``path`` canonically (sorted
        keys, no whitespace); returns the event count."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(other_data), f, sort_keys=True,
                      separators=(",", ":"))
        return len(self.events)


class _DisabledTracer(Tracer):
    """Falsy no-op tracer: the default wiring for every engine."""

    def __bool__(self) -> bool:
        return False

    def set_time(self, t: float) -> None:
        pass

    def span(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass


Tracer.disabled = _DisabledTracer()
