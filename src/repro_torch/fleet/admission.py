"""Admission / degradation control for the serving fleet.

Open-loop load has no back-pressure: when the offered rate exceeds a
replica's service rate, its backlog — and therefore every *new*
session's time-to-first-prediction — grows without bound ("queueing to
death"). The controller gates **new sessions only** (an admitted
incident is never abandoned mid-flight): when the replica a session
routes to predicts a first-prediction wait beyond the deadline, the
session is *shed* to the on-glass provisional path — the same
degradation the ``stream+tiered`` composition uses while an offload is
in flight — where it receives ``degraded``-tagged partial predictions
from its own glasses instead of a spot in the backlog.

Hysteresis: a replica that enters the shedding state keeps shedding new
sessions until its predicted wait falls below ``exit_frac * deadline``
(strictly below the ``enter_frac * deadline`` trigger), so the fleet
drains and *recovers* after a burst instead of oscillating around the
threshold.

The controller is pure bookkeeping over numbers the region simulator
feeds it (predicted wait, queue depth) — no torch, no engine coupling —
so it is unit-testable in isolation and reusable against any backlog
estimator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["AdmissionPolicy", "AdmissionController"]


@dataclass(frozen=True)
class AdmissionPolicy:
    """Deadline- and queue-depth-aware gating thresholds.

    * ``deadline_s`` — target time-to-first-prediction for a newly
      admitted session; the wait prediction is compared against it.
    * ``enter_frac`` / ``exit_frac`` — hysteresis band: start shedding
      when ``predicted_wait > enter_frac * deadline_s``, stop when
      ``predicted_wait < exit_frac * deadline_s``.
    * ``max_queue`` — optional hard cap on a replica's queued events;
      beyond it new sessions shed regardless of the wait estimate.
    """
    deadline_s: float
    enter_frac: float = 1.0
    exit_frac: float = 0.5
    max_queue: Optional[int] = None

    def __post_init__(self):
        if self.deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if not 0.0 < self.exit_frac < self.enter_frac:
            raise ValueError(
                f"need 0 < exit_frac < enter_frac for hysteresis, got "
                f"exit={self.exit_frac}, enter={self.enter_frac}")


class AdmissionController:
    """Per-replica shedding state machine with hysteresis."""

    def __init__(self, policy: AdmissionPolicy, n_replicas: int):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.policy = policy
        self.n_replicas = n_replicas
        self.shedding = [False] * n_replicas
        self.admitted = 0
        self.shed = 0
        # (t, replica, "enter"|"exit") shed-state transitions, for the
        # burst-recovery story and the trace
        self.transitions: List[Tuple[float, int, str]] = []

    def admit(self, replica: int, now: float, predicted_wait_s: float,
              queue_depth: int = 0) -> bool:
        """Decide a NEW session routed to ``replica`` at fleet time
        ``now``: True = admit to the backlog, False = shed to glass."""
        p = self.policy
        hi = p.enter_frac * p.deadline_s
        lo = p.exit_frac * p.deadline_s
        over_cap = (p.max_queue is not None and queue_depth > p.max_queue)
        if self.shedding[replica]:
            if predicted_wait_s < lo and not over_cap:
                self.shedding[replica] = False
                self.transitions.append((now, replica, "exit"))
        else:
            if predicted_wait_s > hi or over_cap:
                self.shedding[replica] = True
                self.transitions.append((now, replica, "enter"))
        ok = not self.shedding[replica]
        if ok:
            self.admitted += 1
        else:
            self.shed += 1
        return ok

    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "transitions": len(self.transitions),
            "shedding_now": sum(self.shedding),
        }


@dataclass
class AdmitAll:
    """Null controller for the shed-vs-queue A/B: every session is
    admitted, nothing ever degrades — the queue-to-death baseline."""
    admitted: int = 0
    shed: int = 0
    transitions: List[Tuple[float, int, str]] = field(default_factory=list)

    def admit(self, replica: int, now: float, predicted_wait_s: float,
              queue_depth: int = 0) -> bool:
        self.admitted += 1
        return True

    def stats(self) -> dict:
        return {"admitted": self.admitted, "shed": 0, "transitions": 0,
                "shedding_now": 0}


__all__.append("AdmitAll")
