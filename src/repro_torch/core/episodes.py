"""EMS episodes: asynchronously-arriving multimodal data sequences.

Table 6 of the paper, verbatim (S = speech/text, V = vitals, I = image/
scene), plus a seeded random-episode generator. Episode 1 is the
canonical Fig.-1 arrival order; 2 and 3 are its shuffles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

_MAP = {"S": "text", "V": "vitals", "I": "scene"}

EPISODE_1 = "S V V V V V V V V V V I I I I I I I I I I"
EPISODE_2 = "I V I V I V I S V I V I I V V I V V I V I"
EPISODE_3 = "V V V V V V I I I I I I V I V V I I S V I"


@dataclass(frozen=True)
class Event:
    index: int
    modality: str              # text | vitals | scene
    arrival_time: float        # seconds since episode start


def parse(seq: str, *, inter_arrival: float = 1.0) -> List[Event]:
    toks = seq.split()
    return [Event(i, _MAP[t], i * inter_arrival) for i, t in enumerate(toks)]


def table6(inter_arrival: float = 1.0):
    return {
        1: parse(EPISODE_1, inter_arrival=inter_arrival),
        2: parse(EPISODE_2, inter_arrival=inter_arrival),
        3: parse(EPISODE_3, inter_arrival=inter_arrival),
    }


def _check_times(ts, *, what="arrival_times") -> List[float]:
    """Validate an explicit per-event arrival-time sequence: finite,
    non-negative, non-decreasing. Returns it as a list of floats."""
    out = [float(t) for t in ts]
    for i, t in enumerate(out):
        if not np.isfinite(t) or t < 0.0:
            raise ValueError(f"{what}[{i}] = {t!r}: need finite t >= 0")
        if i and t < out[i - 1]:
            raise ValueError(f"{what} must be non-decreasing: "
                             f"[{i}] = {t} < [{i - 1}] = {out[i - 1]}")
    return out


def random_episode(n_events: int, seed: int, *, inter_arrival: float = 1.0,
                   arrival_times=None, p=(0.05, 0.5, 0.45)) -> List[Event]:
    """One speech event (paper: a single symptom description) plus a
    random mix of vitals/images — NEMSIS records up to 30 vitals/event.

    ``arrival_times`` replaces the fixed ``i * inter_arrival`` grid with
    an explicit per-event arrival-time sequence (length ``n_events``,
    non-decreasing) — stochastic intra-session lags without a shim.
    """
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["text", "vitals", "scene"], size=n_events, p=p).tolist()
    if "text" not in kinds:
        kinds[rng.integers(n_events)] = "text"
    if arrival_times is not None:
        times = _check_times(arrival_times)
        if len(times) != n_events:
            raise ValueError(f"arrival_times has {len(times)} entries "
                             f"for n_events={n_events}")
    else:
        times = [i * inter_arrival for i in range(n_events)]
    return [Event(i, k, t) for i, (k, t) in enumerate(zip(kinds, times))]


def horizon(episodes) -> float:
    """Latest arrival time across per-session episodes — the episode-time
    span a replay must cover (used to place mid-episode fault injections
    at a fraction of the incident and to scale wall-clock replays)."""
    return max((ev.arrival_time for evs in episodes.values()
                for ev in evs), default=0.0)


def merge_arrivals(episodes):
    """Interleave per-session episodes into one global arrival stream:
    ``{sid: [Event]} -> [(arrival_time, sid, Event)]`` sorted by time
    (ties broken by sid) — what one edge box at one incident sees. The
    single definition shared by the streaming engine, launcher, and
    benchmarks so they can never disagree on arrival order."""
    return sorted(((ev.arrival_time, sid, ev)
                   for sid, evs in episodes.items() for ev in evs),
                  key=lambda x: (x[0], x[1]))


# ----------------------------------------------------------------------
# Asynchronous-arrival scenarios (streaming runtime workloads)
# ----------------------------------------------------------------------

# Per-modality onset-lag distributions: modality -> (mu, sigma) seconds
# until that modality FIRST becomes available, N(mu, sigma) clipped >= 0.
# The three presets mirror how incidents actually unfold in the field:
#   text_first   — the radio transcript lands before anything else
#                  (dispatch/handover speech precedes patient contact);
#   vitals_first — the monitor is hooked up before anyone narrates
#                  (unresponsive patient, vitals stream starts at once);
#   scene_late   — the camera comes up last (glasses donned / scene
#                  detector warm-up while text + vitals already flow).
LAG_SCENARIOS = {
    "text_first":   {"text": (0.0, 0.05), "vitals": (2.0, 0.8),
                     "scene": (5.0, 1.5)},
    "vitals_first": {"vitals": (0.0, 0.1), "text": (3.0, 1.0),
                     "scene": (4.0, 1.5)},
    "scene_late":   {"text": (0.5, 0.3), "vitals": (1.0, 0.4),
                     "scene": (8.0, 2.0)},
}


def async_episode(scenario: str = "text_first", seed: int = 0, *,
                  n_vitals: int = 6, n_scene: int = 3,
                  vitals_period: float = 1.0, scene_period: float = 2.0,
                  lags=None, times=None) -> List[Event]:
    """Episode with per-modality asynchronous onsets.

    Each modality's first arrival is drawn from its lag distribution
    (``lags`` overrides a ``LAG_SCENARIOS`` preset; values are
    ``(mu, sigma)`` pairs). Text is a single utterance; vitals then
    stream every ``vitals_period`` s and scene refreshes every
    ``scene_period`` s after their onsets. Events are returned sorted by
    arrival time and re-indexed — so the *order in which modalities
    appear* varies per seed/scenario, which is exactly the workload the
    streaming runtime must absorb.

    ``times`` — optional ``{modality: [arrival seconds]}``. A modality
    listed here uses that explicit per-event sequence verbatim (one
    event per entry, non-decreasing) instead of the drawn onset + fixed
    period grid, so callers (e.g. the fleet workload generator) can
    carry true stochastic intra-session lags without a shim layer.
    Modalities absent from ``times`` keep the grid behavior, and the
    rng draw order is unchanged when ``times`` is None."""
    spec = dict(lags if lags is not None else LAG_SCENARIOS[scenario])
    times = dict(times or {})
    rng = np.random.default_rng(seed)

    def onset(m):
        mu, sigma = spec[m]
        return float(max(0.0, rng.normal(mu, sigma)))

    def explicit(m):
        return [(m, t) for t in _check_times(times[m], what=f"times[{m!r}]")]

    events = []
    if "text" in times:
        events += explicit("text")
    elif "text" in spec:
        events.append(("text", onset("text")))
    if "vitals" in times:
        events += explicit("vitals")
    elif "vitals" in spec:
        t0 = onset("vitals")
        events += [("vitals", t0 + i * vitals_period)
                   for i in range(max(1, n_vitals))]
    if "scene" in times:
        events += explicit("scene")
    elif "scene" in spec:
        t0 = onset("scene")
        events += [("scene", t0 + i * scene_period)
                   for i in range(max(1, n_scene))]
    events.sort(key=lambda kt: (kt[1], kt[0]))
    return [Event(i, k, t) for i, (k, t) in enumerate(events)]
