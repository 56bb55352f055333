"""Adaptive edge-assisted offloading (EMSServe §4.2.3).

Decision rule, verbatim from the paper: offload a submodule iff
    Δt + t^e  <  t^g
where Δt = payload_bytes / bandwidth (the heartbeat monitor's measured
file-transfer time — "unlike RTT, Δt represents the actual file transfer
time"), t^e the profiled edge inference time, t^g the profiled on-glass
time.

Hardware tiers are reproduced from the paper's Figure 8/Table 2
measurements as slowdown factors over the edge server; the *decisions*
are exercised live against trace-driven bandwidth.

A copy of the 2-tier half of ``repro.core.offload``; the N-tier
``MultiTierPolicy`` and ``SpeculationPolicy`` join with the tiered
slice.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# Paper Fig. 8: per-component slowdown of each tier vs Edge-64X.
# (e.g. YOLO11n: 3.2s glass / 0.08s Edge-4C / 0.03s Edge-64X.)
TIER_FACTORS = {
    "edge64x": 1.0,
    "edge4c": 2.7,
    "ph1": 23.0,
    "glass": 107.0,
}


@dataclass
class ProfileTable:
    """One-time offline profiling result: submodule -> seconds per tier."""
    base: Dict[str, float]                       # measured on this host
    factors: Dict[str, float] = field(default_factory=lambda: dict(TIER_FACTORS))
    host_tier: str = "edge4c"                    # what this host stands for

    def time(self, submodule: str, tier: str) -> float:
        rel = self.factors[tier] / self.factors[self.host_tier]
        return self.base[submodule] * rel


@dataclass
class BandwidthTrace:
    """Piecewise-CONSTANT bandwidth over time (bytes/s). Models EMT
    mobility: walking away from the manpack degrades glass-edge WiFi.

    ``at(t)`` is right-continuous: it returns the value of the last
    point whose time is <= ``t`` (a new measurement takes effect exactly
    at its timestamp). At or before the first point it clamps to the
    first point's value — the trace's earliest measurement extends
    backwards, so probing ``t < points[0][0]`` is well-defined instead
    of silently depending on bisect's underflow behavior. Points are
    sorted at construction (last write wins on duplicate timestamps) and
    an empty trace is rejected eagerly rather than failing inside a
    lookup mid-serve."""
    points: List[Tuple[float, float]]            # (t_seconds, bytes/s)

    def __post_init__(self):
        if not self.points:
            raise ValueError("BandwidthTrace needs at least one point")
        self.points = sorted(self.points, key=lambda p: p[0])
        self._ts = [p[0] for p in self.points]   # cached breakpoints

    @staticmethod
    def static(bw: float):
        return BandwidthTrace([(0.0, bw)])

    @staticmethod
    def walk(distances, bw_at, period=1.0):
        """distances: list of meters over time; bw_at: fn(m)->bytes/s."""
        return BandwidthTrace([(i * period, bw_at(d))
                               for i, d in enumerate(distances)])

    def at(self, t: float) -> float:
        i = max(bisect.bisect_right(self._ts, t) - 1, 0)
        return self.points[i][1]


def nlos_bandwidth(distance_m: float) -> float:
    """WiFi through walls: ~56 Mbps at 0 m decaying ~1 NLOS room / 5 m
    (paper scenario 2: 30 m = 6 rooms). Returns bytes/s."""
    mbps = 56.0 * (0.55 ** (distance_m / 5.0))
    return max(mbps, 0.5) * 1e6 / 8


class HeartbeatMonitor:
    """Lightweight periodic bandwidth sampler (paper: every second)."""

    def __init__(self, trace: BandwidthTrace, period: float = 1.0):
        self.trace = trace
        self.period = period
        self._last_sample_t = None
        self._last_bw = None

    def bandwidth(self, now: float) -> float:
        # quantize to the heartbeat period: decisions use the most
        # recent measurement, not an oracle
        tick = now - (now % self.period)
        if self._last_sample_t != tick:
            self._last_sample_t = tick
            self._last_bw = self.trace.at(tick)
        return self._last_bw

    def delta_t(self, payload_bytes: int, now: float) -> float:
        return payload_bytes / self.bandwidth(now)


@dataclass
class Decision:
    tier: str                  # 'edge' | 'glass'
    delta_t: float
    t_edge: float
    t_glass: float


class AdaptiveOffloadPolicy:
    def __init__(self, profile: ProfileTable, monitor: HeartbeatMonitor,
                 *, glass_tier="glass", edge_tier="edge4c",
                 adaptive: bool = True, force: str | None = None):
        self.profile = profile
        self.monitor = monitor
        self.glass_tier = glass_tier
        self.edge_tier = edge_tier
        self.adaptive = adaptive
        self.force = force                      # 'glass'/'edge' for ablations

    def decide(self, submodule: str, payload_bytes: int, now: float) -> Decision:
        dt = self.monitor.delta_t(payload_bytes, now)
        te = self.profile.time(submodule, self.edge_tier)
        tg = self.profile.time(submodule, self.glass_tier)
        if self.force:
            tier = self.force
        elif not self.adaptive:
            tier = "edge"
        else:
            tier = "edge" if dt + te < tg else "glass"
        return Decision(tier=tier, delta_t=dt, t_edge=te, t_glass=tg)
