"""Seeded chaos schedules for the fault-injection tier.

A field incident does not crash the edge box once, politely, at a time
a benchmark author picked: tiers drop and rejoin repeatedly as the EMT
moves through the building. :func:`chaos_schedule` turns a seed into a
reproducible sequence of :class:`FaultEvent` crash/rejoin cycles over
the remote tiers, which ``EMSServeEngine.inject_schedule`` replays —
each cycle exercising the full crash -> (heartbeat detection) ->
re-dispatch/fallback -> rejoin -> replica re-warm path.

Schedules are validated structurally: per tier, cycles are strictly
ordered and non-overlapping (a box must rejoin before it can crash
again), and every rejoin strictly follows its crash. The generator
draws up/down durations from clipped exponentials, so a seed sweep
covers short blips (a missed heartbeat or two) through long outages.
The draws come from ``np.random.default_rng(seed)`` in a fixed order,
so a seed gives the same schedule as the JAX package's generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class FaultEvent:
    """One crash/rejoin cycle of one remote tier. ``rejoin_at=None``
    means the box stays down for the rest of the episode."""
    crash_at: float
    tier: str
    rejoin_at: Optional[float] = None

    def __post_init__(self):
        if self.rejoin_at is not None and self.rejoin_at <= self.crash_at:
            raise ValueError(
                f"rejoin at {self.rejoin_at} must follow the crash at "
                f"{self.crash_at} ({self.tier})")


def validate_schedule(schedule: Sequence[FaultEvent]) -> List[FaultEvent]:
    """Check per-tier ordering/non-overlap; returns the schedule sorted
    by crash time."""
    by_tier: Dict[str, List[FaultEvent]] = {}
    for e in schedule:
        by_tier.setdefault(e.tier, []).append(e)
    for tier, events in by_tier.items():
        events.sort(key=lambda e: e.crash_at)
        for a, b in zip(events, events[1:]):
            if a.rejoin_at is None:
                raise ValueError(
                    f"{tier}: cycle at {a.crash_at} never rejoins but a "
                    f"later crash at {b.crash_at} is scheduled")
            if b.crash_at < a.rejoin_at:
                raise ValueError(
                    f"{tier}: crash at {b.crash_at} overlaps the outage "
                    f"[{a.crash_at}, {a.rejoin_at})")
    return sorted(schedule, key=lambda e: (e.crash_at, e.tier))


def chaos_schedule(seed: int, *, horizon: float,
                   tiers: Sequence[str],
                   mean_up_s: float = 3.0, mean_down_s: float = 1.5,
                   min_up_s: float = 0.5, min_down_s: float = 0.25,
                   max_cycles_per_tier: int = 8) -> List[FaultEvent]:
    """Reproducible random crash/rejoin cycles over ``tiers`` within
    ``[0, horizon]``.

    Each tier independently alternates up/down periods drawn from
    exponentials with the given means (clipped to the minimums so a
    cycle is never degenerate). A final cycle whose rejoin would land
    beyond the horizon stays down for the rest of the episode — the
    no-surviving-remote glass fallback must get exercised too.
    """
    if horizon <= 0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    rng = np.random.default_rng(seed)
    schedule: List[FaultEvent] = []
    for tier in tiers:
        t = 0.0
        for _ in range(max_cycles_per_tier):
            t += max(min_up_s, float(rng.exponential(mean_up_s)))
            if t >= horizon:
                break
            down = max(min_down_s, float(rng.exponential(mean_down_s)))
            rejoin = t + down
            schedule.append(FaultEvent(
                crash_at=t, tier=tier,
                rejoin_at=rejoin if rejoin < horizon else None))
            if rejoin >= horizon:
                break
            t = rejoin
    return validate_schedule(schedule)
