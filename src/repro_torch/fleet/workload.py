"""Open-loop fleet workload: seeded Poisson / diurnal incident arrivals.

Everything measured before this subsystem was closed-loop: a fixed set
of sessions replayed end to end, each client waiting for the engine.
Field EMS load is the opposite — incidents arrive on their own clock
whether or not the fleet keeps up (open loop), at rates that are bursty
and diurnal. This module generates that load:

  * ``poisson_times`` — homogeneous Poisson process: i.i.d. exponential
    inter-arrival gaps at ``rate`` sessions/s over ``[0, horizon)``.
  * ``diurnal_times`` — inhomogeneous Poisson via thinning against the
    sinusoidal envelope ``diurnal_rate`` (peak rate ``base*(1+amp)``);
    candidate points are drawn at the peak rate and accepted with
    probability ``lambda(t)/peak``, the textbook exact method.
  * ``generate_workload`` — spawns a whole ``IncidentSession`` per
    arrival: scenario cycled over ``core.episodes.LAG_SCENARIOS``, and
    *stochastic* intra-session modality lags (exponentially-jittered
    vitals/scene gaps around the scenario's periods) carried as an
    explicit per-event arrival-time sequence through
    ``async_episode(times=...)`` — no fixed grids.

Determinism: every draw flows from ``np.random.default_rng`` seeded by
``(seed, stream-tag[, session index])``, so the same ``(rate, horizon,
seed)`` always yields the identical workload, event for event.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.episodes import Event, LAG_SCENARIOS, async_episode

__all__ = ["IncidentSession", "poisson_times", "diurnal_rate",
           "diurnal_times", "generate_workload", "merge_sessions"]


@dataclass(frozen=True)
class IncidentSession:
    """One incident: a session id, its absolute start time, and the
    relative-time event sequence (``Event.arrival_time`` is seconds
    since *session* start — shift by ``t_start`` for fleet time)."""
    sid: str
    t_start: float
    scenario: str
    events: Tuple[Event, ...]

    def absolute_events(self) -> List[Event]:
        return [Event(e.index, e.modality, self.t_start + e.arrival_time)
                for e in self.events]


# ---------------------------------------------------------------- arrivals

def poisson_times(rate: float, horizon: float, seed: int = 0) -> List[float]:
    """Arrival instants of a homogeneous Poisson process on [0, horizon)."""
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if horizon <= 0.0:
        return []
    rng = np.random.default_rng([seed, 0x9015])
    out: List[float] = []
    t = float(rng.exponential(1.0 / rate))
    while t < horizon:
        out.append(t)
        t += float(rng.exponential(1.0 / rate))
    return out


def diurnal_rate(t: float, base_rate: float, *, amp: float = 0.6,
                 period: float = 86400.0, phase: float = 0.0) -> float:
    """Sinusoidal rate envelope ``base*(1 + amp*sin(2pi (t-phase)/period))``
    — bounded in ``[base*(1-amp), base*(1+amp)]`` for ``0 <= amp < 1``."""
    if not 0.0 <= amp < 1.0:
        raise ValueError(f"amp must be in [0, 1), got {amp}")
    return base_rate * (1.0 + amp * math.sin(2.0 * math.pi
                                             * (t - phase) / period))


def diurnal_times(base_rate: float, horizon: float, seed: int = 0, *,
                  amp: float = 0.6, period: float = 86400.0,
                  phase: float = 0.0) -> List[float]:
    """Inhomogeneous Poisson arrivals under the diurnal envelope, by
    exact thinning against the peak rate."""
    if base_rate <= 0.0:
        raise ValueError(f"base_rate must be > 0, got {base_rate}")
    if not 0.0 <= amp < 1.0:
        raise ValueError(f"amp must be in [0, 1), got {amp}")
    if horizon <= 0.0:
        return []
    peak = base_rate * (1.0 + amp)
    rng = np.random.default_rng([seed, 0xD1CA])
    out: List[float] = []
    t = float(rng.exponential(1.0 / peak))
    while t < horizon:
        accept = diurnal_rate(t, base_rate, amp=amp, period=period,
                              phase=phase) / peak
        if rng.uniform() < accept:
            out.append(t)
        t += float(rng.exponential(1.0 / peak))
    return out


# ---------------------------------------------------------------- sessions

def _session_times(scenario: str, rng, *, n_vitals: int, n_scene: int,
                   vitals_period: float,
                   scene_period: float) -> Dict[str, List[float]]:
    """Stochastic intra-session lags: per-modality onset drawn from the
    LAG_SCENARIOS distribution, then exponentially-jittered gaps with
    the scenario's mean period — a true per-event arrival sequence."""
    spec = LAG_SCENARIOS[scenario]

    def onset(m):
        mu, sigma = spec[m]
        return float(max(0.0, rng.normal(mu, sigma)))

    def stream(m, n, mean_gap):
        t = onset(m)
        ts = [t]
        for _ in range(max(1, n) - 1):
            t += float(rng.exponential(mean_gap))
            ts.append(t)
        return ts

    return {
        "text": [onset("text")],
        "vitals": stream("vitals", n_vitals, vitals_period),
        "scene": stream("scene", n_scene, scene_period),
    }


def generate_workload(rate: float, horizon: float, *, seed: int = 0,
                      process: str = "poisson", amp: float = 0.6,
                      period: float = 60.0, phase: float = 0.0,
                      scenarios: Sequence[str] = ("text_first",
                                                  "vitals_first",
                                                  "scene_late"),
                      n_vitals: int = 3, n_scene: int = 2,
                      vitals_period: float = 1.0,
                      scene_period: float = 2.0,
                      time_scale: float = 1.0,
                      sid_prefix: str = "f") -> List[IncidentSession]:
    """Spawn whole incident sessions at an offered ``rate`` (sessions/s)
    over ``[0, horizon)`` seconds of fleet time.

    ``process`` is ``"poisson"`` (homogeneous) or ``"diurnal"``
    (sinusoidal modulation with ``amp``/``period``/``phase``). Each
    session cycles through ``scenarios`` and carries stochastic
    intra-session modality lags via ``async_episode(times=...)``.

    ``time_scale`` multiplies every INTRA-session time (modality onsets
    and stream gaps; session start instants are untouched): real
    incidents unfold over ~10 s, so a capacity benchmark that must
    reach serving-limited steady state within a short horizon compresses
    the session timescale instead of inflating the horizon."""
    if time_scale <= 0.0:
        raise ValueError(f"time_scale must be > 0, got {time_scale}")
    if process == "poisson":
        starts = poisson_times(rate, horizon, seed)
    elif process == "diurnal":
        starts = diurnal_times(rate, horizon, seed, amp=amp,
                               period=period, phase=phase)
    else:
        raise ValueError(f"process must be 'poisson' or 'diurnal', "
                         f"got {process!r}")
    sessions: List[IncidentSession] = []
    for i, t0 in enumerate(starts):
        scen = scenarios[i % len(scenarios)]
        rng = np.random.default_rng([seed, 0x5E55, i])
        times = _session_times(scen, rng, n_vitals=n_vitals,
                               n_scene=n_scene,
                               vitals_period=vitals_period,
                               scene_period=scene_period)
        if time_scale != 1.0:
            times = {m: [t * time_scale for t in ts]
                     for m, ts in times.items()}
        events = async_episode(scen, times=times)
        sessions.append(IncidentSession(sid=f"{sid_prefix}{i}",
                                        t_start=float(t0), scenario=scen,
                                        events=tuple(events)))
    return sessions


def merge_sessions(sessions: Sequence[IncidentSession]):
    """Interleave sessions into one global fleet arrival stream:
    ``[(absolute_time, sid, Event)]`` sorted by time (ties by sid) —
    the same discipline as ``core.episodes.merge_arrivals``."""
    out = [(s.t_start + e.arrival_time, s.sid, e)
           for s in sessions for e in s.events]
    out.sort(key=lambda x: (x[0], x[1]))
    return out
