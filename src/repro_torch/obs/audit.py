"""Trace-replay invariant auditor.

Re-verifies the serving stack's invariants from an exported trace
ALONE — no access to the engine, the cache, or the transport objects —
so a trace file is a self-contained proof obligation: if the runtime
lied about what happened, the replay catches the inconsistency.

Invariants checked (in program order = the per-tracer ``seq`` number,
NOT timestamps — in tiered mode distinct hosts' spans legitimately
overlap in simulated time):

  I1 **exactly-one commit** — at most one *accepted* ``cache.commit``
     per (session key, modality, step) between drops; versions
     increment by exactly 1 per accepted commit (0 after a drop);
     refused commits carry a consistent reason (``duplicate`` means
     the held step, ``stale`` means an older step).
  I2 **bounded staleness** — every ``fuse`` event's consumed features
     satisfy ``input_step - src_step <= max_staleness``.
  I3 **byte conservation** — flight ids are unique fabric-wide; every
     ``transport.cancel`` names a live flight on its own channel, at
     most once, strictly before its delivery instant (a cancelled
     flight never delivers); per channel,
     ``sent == delivered + cancelled`` in both bytes and messages;
     when the export embeds live channel stats (``otherData``), the
     trace-derived totals must match them exactly.
  I4 **no prediction before its inputs** — every feature a ``fuse``
     consumes was stamped (an accepted commit or a ``cache.touch``
     re-stamp at that exact step) EARLIER in program order; every
     ``emit`` is preceded by the ``fuse`` that produced it.

Run from the command line against an exported trace::

    python -m repro_torch.obs.audit trace.json
    python -m repro_torch.obs.audit trace.jsonl     # StreamingTracer output

exits 0 when clean, 1 on invariant violations, 2 on a schema-invalid
trace (not Chrome trace-event JSON, nor StreamingTracer JSON Lines).
Pure Python, a copy of ``repro.obs.audit``: it reads traces of either
package.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["AuditReport", "validate_chrome", "audit_doc", "audit_tracer",
           "audit_file", "jsonl_to_chrome"]

_PHASES = {"X", "i", "M"}


@dataclass
class AuditReport:
    violations: List[str] = field(default_factory=list)
    checks: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        done = ", ".join(f"{k}={v}" for k, v in sorted(self.checks.items()))
        head = ("audit OK" if self.ok
                else f"audit FAILED ({len(self.violations)} violations)")
        return f"{head} [{done}]"


# ======================================================================
# schema validation (Chrome trace-event JSON object form)
# ======================================================================

def validate_chrome(doc) -> List[str]:
    """Structural errors that would make the file unloadable/meaningless
    to Perfetto or to this auditor. Empty list == valid."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a Chrome trace-event JSON object "
                "(missing top-level 'traceEvents')"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' is not a list"]
    for n, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event[{n}]: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            errs.append(f"event[{n}]: bad ph {ph!r}")
            continue
        for k in ("name", "pid", "tid", "ts"):
            if k not in e:
                errs.append(f"event[{n}] ({e.get('name')!r}): missing {k!r}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event[{n}] ({e.get('name')!r}): bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event[{n}] ({e.get('name')!r}): "
                            f"bad dur {dur!r}")
        if ph != "M" and "seq" not in e.get("args", {}):
            errs.append(f"event[{n}] ({e.get('name')!r}): args missing seq")
        if len(errs) > 20:
            errs.append("... (truncated)")
            break
    return errs


# ======================================================================
# replay
# ======================================================================

def _seq_ordered(doc):
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    return sorted(evs, key=lambda e: e["args"]["seq"])


def audit_doc(doc, *, max_staleness: int = 1) -> AuditReport:
    """Replay a Chrome trace doc and re-verify the serving invariants."""
    rep = AuditReport()
    bad = lambda msg: rep.violations.append(msg)  # noqa: E731

    # live cache model: (key, modality) -> (step, version) or absent
    live: Dict[tuple, tuple] = {}
    # every step ever stamped for a (key, modality) since its last drop
    stamped: Dict[tuple, set] = {}
    # flights: id -> dict(channel, nbytes, t_deliver, cancelled)
    flights: Dict[int, dict] = {}
    chan_sent: Dict[str, List[int]] = {}   # channel -> [msgs, bytes]
    chan_cancel: Dict[str, List[int]] = {}
    fused: set = set()                     # (key, model, step) seen at fuse
    n = dict(commits=0, touches=0, fuses=0, emits=0, flights=0,
             cancels=0, drops=0)

    for e in _seq_ordered(doc):
        name, a = e["name"], e.get("args", {})
        seq = a.get("seq")

        if name == "cache.commit":
            n["commits"] += 1
            ck = (a["key"], a["modality"])
            step = a["step"]
            cur = live.get(ck)
            if a.get("accepted"):
                if cur is not None and step <= cur[0]:
                    bad(f"I1 seq={seq}: accepted commit at step {step} "
                        f"for {ck} but cache already holds step {cur[0]} "
                        "(duplicate/stale accepted)")
                want = 0 if cur is None else cur[1] + 1
                ver = a.get("version")
                if ver != want:
                    bad(f"I1 seq={seq}: commit version {ver} for {ck} "
                        f"(expected {want})")
                live[ck] = (step, ver if isinstance(ver, int) else want)
                stamped.setdefault(ck, set()).add(step)
            else:
                reason = a.get("reason")
                if cur is None:
                    bad(f"I1 seq={seq}: refused commit for {ck} "
                        "with no live entry")
                elif reason == "duplicate" and step != cur[0]:
                    bad(f"I1 seq={seq}: 'duplicate' refusal at step "
                        f"{step} but cache holds step {cur[0]}")
                elif reason == "stale" and step >= cur[0]:
                    bad(f"I1 seq={seq}: 'stale' refusal at step {step} "
                        f"but cache holds step {cur[0]}")

        elif name == "cache.touch":
            n["touches"] += 1
            ck = (a["key"], a["modality"])
            cur = live.get(ck)
            if cur is None:
                bad(f"I4 seq={seq}: touch of absent entry {ck}")
            else:
                live[ck] = (a["step"], cur[1])
                stamped.setdefault(ck, set()).add(a["step"])

        elif name == "cache.drop":
            n["drops"] += 1
            for key, mod in a.get("dropped", []):
                live.pop((key, mod), None)
                stamped.pop((key, mod), None)

        elif name == "fuse":
            n["fuses"] += 1
            key = a["key"]
            for m, (src_step, input_step) in a["consumed"].items():
                lag = input_step - src_step
                if lag > max_staleness:
                    bad(f"I2 seq={seq}: fuse of {key}/{m} consumed step "
                        f"{src_step} against input step {input_step} "
                        f"(lag {lag} > max {max_staleness})")
                if src_step not in stamped.get((key, m), ()):
                    bad(f"I4 seq={seq}: fuse of {key}/{m} consumed step "
                        f"{src_step} never committed/touched before it")
            fused.add((key, a.get("model"), a.get("step")))

        elif name == "emit":
            n["emits"] += 1
            fk = (a["key"], a.get("model"), a.get("step"))
            if fk not in fused:
                bad(f"I4 seq={seq}: emit of {fk} with no prior fuse")

        elif name == "transport.flight":
            n["flights"] += 1
            fid = a["flight"]
            if fid in flights:
                bad(f"I3 seq={seq}: duplicate flight id {fid}")
            flights[fid] = {"channel": a["channel"], "nbytes": a["nbytes"],
                            "t_deliver": a["t_deliver"], "cancelled": False}
            s = chan_sent.setdefault(a["channel"], [0, 0])
            s[0] += 1
            s[1] += a["nbytes"]

        elif name == "transport.cancel":
            n["cancels"] += 1
            fid = a["flight"]
            f = flights.get(fid)
            if f is None:
                bad(f"I3 seq={seq}: cancel of unknown flight {fid}")
                continue
            if f["cancelled"]:
                bad(f"I3 seq={seq}: flight {fid} cancelled twice")
                continue
            if f["channel"] != a["channel"]:
                bad(f"I3 seq={seq}: cancel of flight {fid} on channel "
                    f"{a['channel']} but it flew on {f['channel']}")
            if a["t"] >= f["t_deliver"] - 1e-12:
                bad(f"I3 seq={seq}: flight {fid} cancelled at t={a['t']} "
                    f">= its delivery {f['t_deliver']} — a delivered "
                    "flight cannot be recalled")
            f["cancelled"] = True
            c = chan_cancel.setdefault(f["channel"], [0, 0])
            c[0] += 1
            c[1] += f["nbytes"]

    # ---- I3 conservation against embedded live channel stats --------
    stats = (doc.get("otherData") or {}).get("transport") or {}
    for ch, s in stats.items():
        sent = chan_sent.get(ch, [0, 0])
        canc = chan_cancel.get(ch, [0, 0])
        if (s.get("msgs") != sent[0] or s.get("bytes") != sent[1]
                or s.get("cancelled_msgs") != canc[0]
                or s.get("cancelled_bytes") != canc[1]):
            bad(f"I3 channel {ch}: trace-derived "
                f"(msgs={sent[0]}, bytes={sent[1]}, "
                f"cancelled_msgs={canc[0]}, cancelled_bytes={canc[1]}) "
                f"!= live stats ({s})")
    # internal conservation: delivered + cancelled == sent, per channel
    for ch, (msgs, nbytes) in chan_sent.items():
        cm, cb = chan_cancel.get(ch, [0, 0])
        delivered_m = sum(1 for f in flights.values()
                          if f["channel"] == ch and not f["cancelled"])
        delivered_b = sum(f["nbytes"] for f in flights.values()
                          if f["channel"] == ch and not f["cancelled"])
        if delivered_m + cm != msgs or delivered_b + cb != nbytes:
            bad(f"I3 channel {ch}: delivered+cancelled != sent "
                f"({delivered_m}+{cm} msgs vs {msgs}; "
                f"{delivered_b}+{cb} bytes vs {nbytes})")

    rep.checks = n
    return rep


def audit_tracer(tracer, *, max_staleness: int = 1,
                 other_data: Optional[dict] = None) -> AuditReport:
    """Audit an in-memory :class:`~repro_torch.obs.trace.Tracer` directly."""
    return audit_doc(tracer.to_chrome(other_data),
                     max_staleness=max_staleness)


def jsonl_to_chrome(path) -> dict:
    """Load a ``StreamingTracer`` JSON Lines file into a Chrome
    trace-event doc (Perfetto-loadable and ``audit_doc``-able).

    Each line is one event record carrying its track by *name*; this
    loader assigns tids from the sorted track-name set, prepends the
    ``ph="M"`` metadata events, and sorts by ``(ts, seq)`` exactly like
    ``Tracer.to_chrome``. A ``{"otherData": ...}`` line (written by
    ``StreamingTracer.close``) becomes the doc's ``otherData``.
    Raises ``ValueError`` on a malformed line.
    """
    events: List[dict] = []
    other = None
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"line {ln}: not JSON — {e}") from None
            if not isinstance(rec, dict):
                raise ValueError(f"line {ln}: not an object")
            if "otherData" in rec and "ph" not in rec:
                other = rec["otherData"]
                continue
            events.append(rec)
    tracks = sorted({e.get("track", "engine") for e in events})
    tids = {name: i + 1 for i, name in enumerate(tracks)}
    out = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
            "ts": 0, "args": {"name": "EMSServe"}}]
    for name, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid, "ts": 0, "args": {"name": name}})
    for e in sorted(events, key=lambda e: (e.get("ts", 0),
                                           e.get("args", {}).get("seq", 0))):
        ev = dict(e)
        ev["pid"] = 1
        ev["tid"] = tids[ev.pop("track", "engine")]
        if ev.get("ph") == "i":
            ev.setdefault("s", "t")
        out.append(ev)
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if other:
        doc["otherData"] = other
    return doc


def _load_any(path) -> dict:
    """Load a trace file in either format: Chrome JSON object or
    StreamingTracer JSON Lines (sniffed by suffix, then by content)."""
    if str(path).endswith(".jsonl"):
        return jsonl_to_chrome(path)
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError:
            return jsonl_to_chrome(path)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return doc
    # a one-line JSONL file parses as plain JSON but is not a trace doc
    return jsonl_to_chrome(path)


def audit_file(path, *, max_staleness: int = 1) -> AuditReport:
    """Validate + audit an exported trace file (Chrome JSON or
    StreamingTracer JSONL). Schema errors are reported as violations
    prefixed ``schema:``."""
    try:
        doc = _load_any(path)
    except ValueError as e:
        return AuditReport(violations=[f"schema: {e}"])
    errs = validate_chrome(doc)
    if errs:
        return AuditReport(violations=[f"schema: {e}" for e in errs])
    return audit_doc(doc, max_staleness=max_staleness)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.audit",
        description="Re-verify serving invariants from a trace file.")
    p.add_argument("path", help="Chrome trace-event JSON exported by "
                                "repro_torch.obs.Tracer, or JSON Lines from "
                                "repro_torch.obs.StreamingTracer")
    p.add_argument("--max-staleness", type=int, default=1)
    args = p.parse_args(argv)

    try:
        doc = _load_any(args.path)
    except ValueError as e:
        print(f"schema: {e}")
        return 2
    errs = validate_chrome(doc)
    if errs:
        for e in errs:
            print(f"schema: {e}")
        return 2
    rep = audit_doc(doc, max_staleness=args.max_staleness)
    for v in rep.violations:
        print(v)
    print(rep.summary())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
