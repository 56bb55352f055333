"""Structured span tracer on the injected serving clock.

``Tracer`` records spans and instants (cache commits, touches, drops,
...) with a monotone per-tracer sequence number; export stable-sorts by
``(ts, seq)`` and serialises with sorted keys, so under a deterministic
clock the exported file is byte-reproducible. The export is the Chrome
trace-event JSON object form, loadable in Perfetto.

``Tracer.disabled`` is a shared no-op singleton that is falsy, so hot
paths guard instrumentation with ``if self.tracer:`` and pay one branch
when tracing is off.

``StreamingTracer`` is the bounded-memory variant for long runs: a ring
of events spilled to a JSON Lines file, auditable with the same auditor
(``obs.audit``). A copy of ``repro.obs.trace``.
"""
from __future__ import annotations

import json
from typing import Callable, List, Optional

__all__ = ["Tracer", "TraceEvent", "StreamingTracer"]


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


class StreamingTracer(Tracer):
    """Bounded-memory tracer for long open-loop runs: O(buffer), not
    O(events).

    Events accumulate in the in-memory ring (``self.events``); whenever
    it reaches ``buffer`` entries they are spilled to ``path`` as JSON
    Lines — one canonical-JSON event per line, in *seq* (program) order,
    the order the trace-replay auditor consumes. ``close()`` flushes the
    tail and (optionally) appends a final ``{"otherData": ...}`` line
    carrying live channel/metrics stats for the auditor's conservation
    cross-check. The resulting ``.jsonl`` file is auditable with
    ``python -m repro_torch.obs.audit`` (``audit_file`` sniffs the format).

    Unlike ``Tracer.export`` there is no global ``(ts, seq)`` sort — a
    bounded writer cannot sort what it has already spilled — so the
    JSONL is an *audit/archive* format; convert to a Perfetto-loadable
    Chrome doc offline with ``obs.audit.jsonl_to_chrome``.
    """

    def __init__(self, path, *, buffer: int = 1024,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(clock)
        if buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {buffer}")
        self.path = path
        self.buffer = buffer
        self.events_written = 0
        self._fh = open(path, "w")
        self._closed = False

    # ---- record (spill when the ring fills) -------------------------
    def span(self, name: str, cat: str, t0: float, t1: float, *,
             track: str = "engine", **args) -> None:
        super().span(name, cat, t0, t1, track=track, **args)
        if len(self.events) >= self.buffer:
            self._spill()

    def instant(self, name: str, cat: str, at: Optional[float] = None, *,
                track: str = "engine", **args) -> None:
        super().instant(name, cat, at, track=track, **args)
        if len(self.events) >= self.buffer:
            self._spill()

    # ---- spill ------------------------------------------------------
    @staticmethod
    def event_line(e: TraceEvent) -> dict:
        """One JSONL record: the Chrome event fields (ts/dur in
        microseconds, like ``to_chrome``) with the track kept by name
        (tid assignment needs the full track set — the offline
        converter does it)."""
        ev = {
            "name": e.name,
            "cat": e.cat,
            "ph": "X" if e.dur is not None else "i",
            "ts": round(e.ts * 1e6, 3),
            "track": e.track,
            "args": {**e.args, "seq": e.seq},
        }
        if e.dur is not None:
            ev["dur"] = round(e.dur * 1e6, 3)
        return ev

    def _spill(self) -> None:
        for e in self.events:
            json.dump(self.event_line(e), self._fh,
                      sort_keys=True, separators=(",", ":"))
            self._fh.write("\n")
            self.events_written += 1
        del self.events[:]

    # ---- finalize ---------------------------------------------------
    def close(self, other_data: Optional[dict] = None) -> int:
        """Flush the ring and close the file; returns total events
        written. Idempotent (later calls are no-ops)."""
        if self._closed:
            return self.events_written
        self._spill()
        if other_data is not None:
            json.dump({"otherData": other_data}, self._fh,
                      sort_keys=True, separators=(",", ":"))
            self._fh.write("\n")
        self._fh.close()
        self._closed = True
        return self.events_written

    def export(self, path=None, other_data: Optional[dict] = None) -> int:
        """Streaming tracers export by finalizing their own JSONL file
        (``path`` must be None or the constructor path)."""
        if path is not None and path != self.path:
            raise ValueError(
                f"StreamingTracer writes to {self.path!r}; cannot "
                f"export to {path!r} (use jsonl_to_chrome offline)")
        return self.close(other_data)

    def __enter__(self) -> "StreamingTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
