"""Wall-clock serving loop: deadline flushing without manual ``poll()``.

A flush-mode engine with a deadline buffers arrivals until the deadline
expires, but by itself re-checks that deadline only when something calls
``submit``/``poll`` — fine for episode-time replays, wrong for a live
deployment where the *last* arrivals of a lull must still flush on time.
This driver replays a timed arrival stream against a **monotonic clock**
and pumps the engine's ``poll()`` between arrivals and through trailing
lulls, so deadline-driven flushes fire from real time.

Works against any engine exposing ``submit(sid, event, payload)`` /
``poll()`` / ``drain()``: a stream engine (poll fires its deadline
flushes and eviction sweeps) or a tiered one (per-arrival, poll is a
no-op); the launcher's ``--wall-clock`` runs through it.

``clock``/``sleep_fn`` are injectable so tests can drive simulated wall
time deterministically; ``speed`` scales episode seconds to wall seconds
(``speed=60`` replays a one-minute incident in a second).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..core.episodes import Event, merge_arrivals


@dataclass
class LoopStats:
    arrivals: int = 0
    polls: int = 0
    flushes_fired: int = 0      # flushes triggered by this loop's polls
    wall_s: float = 0.0


class WallClockDriver:
    """Pumps an engine's deadline flushes from a monotonic clock while
    replaying a timed arrival stream."""

    def __init__(self, engine, *, speed: float = 1.0,
                 poll_interval_s: float = 0.005,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.speed = speed
        self.poll_interval_s = poll_interval_s
        self.clock = clock
        self.sleep_fn = sleep_fn
        self.stats = LoopStats()

    def _pending(self) -> int:
        count = getattr(self.engine, "pending_count", None)
        return count() if callable(count) else 0

    def _pump_until(self, t0: float, episode_t: Optional[float]):
        """Poll the engine until wall time reaches episode time
        ``episode_t`` (None: until nothing is pending any more)."""
        while True:
            now_ep = (self.clock() - t0) * self.speed
            if episode_t is not None and now_ep >= episode_t:
                return
            if episode_t is None and (
                    not self._pending()
                    or getattr(self.engine, "deadline_s", None) is None):
                # nothing left to flush, or flushing is caller-driven
                # (deadline_s=None): the trailing drain() handles it
                return
            if self.engine.poll() is not None:
                self.stats.flushes_fired += 1
            self.stats.polls += 1
            if episode_t is None:
                wait = self.poll_interval_s
            else:
                wait = min(self.poll_interval_s,
                           max(0.0, (episode_t - now_ep) / self.speed))
            self.sleep_fn(wait)

    def run(self, episodes: Dict[str, List[Event]], payload_fn, *,
            aggregate=None):
        """Replay ``episodes`` in global arrival order on the wall clock;
        returns the loop stats. Trailing pending arrivals are pumped until
        their deadline fires (never drained early: the deadline policy
        stays in charge; a final ``drain`` only catches engines with no
        deadline at all)."""
        t_start = self.clock()
        for t, sid, ev in merge_arrivals(episodes):
            self._pump_until(t_start, t)
            self.engine.submit(sid, ev, payload_fn(sid, ev),
                               aggregate=aggregate)
            self.stats.arrivals += 1
        self._pump_until(t_start, None)
        self.engine.drain()
        self.stats.wall_s = self.clock() - t_start
        return self.stats
