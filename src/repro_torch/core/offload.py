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

A copy of ``repro.core.offload``: the 2-tier rule above, and its N-tier
generalisation below (``MultiTierPolicy`` with the joint (tier,
precision) enumeration, per-submodule tail placement and the
``SpeculationPolicy`` hedging rung).
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

# The int8 rung's cost model: an int8 candidate's encoder compute, and its
# feature-return bytes, as fractions of the float32 ones (the packed
# feature is d + 4 bytes against 4d).
INT8_COMPUTE_SCALE = 0.5
INT8_BYTES_SCALE = 0.25


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


# ======================================================================
# N-tier generalization (glass / phone / edge boxes)
# ======================================================================

@dataclass(frozen=True)
class SpeculationPolicy:
    """When to hedge a placement with a speculative dual dispatch.

    ``deadline_s`` is the per-arrival serving-latency budget (the EMT
    needs the prediction within this window of the datum arriving);
    ``margin_s`` is the pressure threshold: when the chosen placement's
    *estimated* completion leaves less than ``margin_s`` of slack before
    the deadline, the estimate can no longer be trusted to hold (the
    heartbeat-quantized bandwidth it is built on lags the wire), so the
    engine dispatches the submodule on the local tier AND the best
    remote, commits whichever returns first, and cancels the loser."""
    deadline_s: float
    margin_s: float = 0.0

    def should_speculate(self, est_cost_s: float,
                         lateness_s: float = 0.0) -> bool:
        """Margin = deadline - time already burned - estimated cost;
        speculate when it dips below the configured threshold."""
        return (self.deadline_s - lateness_s - est_cost_s) < self.margin_s


@dataclass(frozen=True)
class TierEstimate:
    """One candidate (tier, precision)'s cost breakdown for one
    submodule placement. ``precision`` stays ``"fp32"`` unless the
    policy runs the joint precision+placement enumeration."""
    tier: str                  # host name
    transfer_s: float          # Δt to ship the inputs there (+ outputs home)
    queue_s: float             # current queueing delay on that host
    compute_s: float           # profiled submodule time on that tier
    precision: str = "fp32"    # numeric precision this estimate assumes

    @property
    def cost(self) -> float:
        return self.transfer_s + self.queue_s + self.compute_s


@dataclass
class TierDecision:
    """Outcome of one per-(submodule, tier) placement evaluation."""
    tier: str                            # chosen host name
    local: str                           # the always-available local host
    estimates: Dict[str, TierEstimate]   # every candidate evaluated
    speculate: bool = False              # deadline margin too thin: race
    margin_s: float = float("inf")       # slack the estimate left
    precision: str = "fp32"              # precision of the chosen estimate

    @property
    def best_remote(self) -> "str | None":
        """Name of the chosen remote, or of the cheapest remote candidate
        when the argmin picked the local tier (the speculation partner)."""
        e = self._remote
        return e.tier if e is not None else None

    # ---- legacy 2-tier views (Decision compatibility)
    @property
    def _remote(self):
        remotes = [e for n, e in self.estimates.items() if n != self.local]
        if not remotes:
            return None
        if self.tier != self.local and self.tier in self.estimates:
            return self.estimates[self.tier]
        return min(remotes, key=lambda e: (e.cost, e.tier))

    @property
    def delta_t(self) -> float:
        e = self._remote
        return e.transfer_s if e is not None else 0.0

    @property
    def t_edge(self) -> float:
        e = self._remote
        return e.compute_s if e is not None else float("inf")

    @property
    def t_glass(self) -> float:
        return self.estimates[self.local].compute_s


class MultiTierPolicy:
    """The paper's Δt + t^e < t^g rule generalized to an ordered list of
    N tiers with per-link bandwidth monitors and contention awareness:

        place(submodule) = argmin_k [ Δt_k + queue_k + t_k(submodule) ]

    over the local tier (Δt = 0) and every *usable* remote, where
    ``queue_k`` is the tier's current work-queue delay (0 when the
    caller runs contention-blind — the paper-verbatim rule) and Δt_k is
    the heartbeat-measured transfer time on that tier's link. With one
    remote and no queues this reduces exactly to the 2-tier rule.

    ``force`` pins placement for ablations: a host name pins everything;
    a ``{submodule: host}`` dict pins per submodule (unlisted submodules
    stay adaptive). A forced tier that is currently unavailable falls
    back to the local host.

    ``speculation`` (a :class:`SpeculationPolicy`) arms the hedging
    rung: a decision whose estimated completion leaves less than the
    configured margin before the deadline is marked ``speculate`` — the
    engine then dispatches the submodule on the local tier AND the best
    remote and commits whichever returns first. Forced and non-adaptive
    decisions never speculate (ablations must stay pinned).

    ``precisions`` (host -> tuple of supported precisions, e.g.
    ``{"glass": ("fp32", "int8")}``) arms the JOINT precision+placement
    enumeration: the argmin then runs over (tier, precision) candidates
    where int8 scales a tier's compute by ``INT8_COMPUTE_SCALE`` and —
    because int8-packed features are what ships home — scales the
    feature-return bytes by ``INT8_BYTES_SCALE``. The winning estimate's
    precision rides on the decision, so the engine sends quantized
    features exactly when the uplink is the bottleneck and raw when it
    isn't. Unset (None), every path below is BIT-IDENTICAL to the
    precision-less rule; hosts absent from the dict are fp32-only.
    """

    def __init__(self, profile: ProfileTable,
                 monitors: Dict[str, HeartbeatMonitor], *,
                 local: str, tier_of: Dict[str, str],
                 adaptive: bool = True,
                 force: "str | Dict[str, str] | None" = None,
                 speculation: "SpeculationPolicy | None" = None,
                 precisions: "Dict[str, tuple] | None" = None):
        self.profile = profile
        self.monitors = monitors            # remote host name -> its link
        self.local = local
        self.tier_of = dict(tier_of)        # host name -> ProfileTable key
        self.remote_names = [n for n in tier_of if n != local]
        self.adaptive = adaptive
        self.force = force
        self.speculation = speculation
        self.precisions = (None if precisions is None
                           else {h: tuple(p) for h, p in precisions.items()})
        if self.precisions is not None:
            for h, ps in self.precisions.items():
                bad = set(ps) - {"fp32", "int8"}
                if h not in tier_of or bad:
                    raise ValueError(
                        f"precisions[{h!r}]={ps}: unknown host or "
                        f"precision (hosts {sorted(tier_of)}, "
                        "precisions fp32/int8)")
        names = set(tier_of)
        forced = (force.values() if isinstance(force, dict)
                  else [force] if force else [])
        for f in forced:
            if f not in names:
                raise ValueError(f"force names unknown tier {f!r}; "
                                 f"hosts are {sorted(names)}")

    def _forced(self, submodule: str):
        if isinstance(self.force, dict):
            return self.force.get(submodule)
        return self.force

    def link_bw(self, a: str, b: str, now: float) -> float:
        """Heartbeat-quantized bandwidth of the a->b link: each remote
        tier owns one radio link, so a transfer traverses every remote
        endpoint's link and the slower one bottlenecks. Local<->local
        never happens on a wire (infinite)."""
        bws = [self.monitors[x].bandwidth(now)
               for x in (a, b) if x != self.local]
        return min(bws) if bws else float("inf")

    def _pick(self, submodule: str, estimates: Dict[str, TierEstimate],
              prefer: str | None = None) -> str:
        forced = self._forced(submodule)
        if forced is not None:
            return forced if forced in estimates else self.local
        remotes = [e for n, e in estimates.items() if n != self.local]
        if not self.adaptive:
            if not remotes:
                return self.local
            return min(remotes, key=lambda e: (e.cost, e.tier)).tier
        best = min(estimates.values(),
                   key=lambda e: (e.cost, e.tier != prefer, e.tier))
        return best.tier

    def decide(self, submodule: str, payload_bytes: int, now: float, *,
               queues: "Dict[str, float] | None" = None,
               available=None, lateness_s: float = 0.0,
               feat_bytes: int = 0) -> TierDecision:
        """Place one submodule whose raw inputs currently sit on the
        local tier. ``available`` restricts the remote candidates (a
        crashed tier is not a candidate); ``queues`` carries each host's
        current queueing delay (omit for the contention-blind rule);
        ``lateness_s`` is serving time already burned against this
        arrival's deadline (feeds the speculation margin).

        ``feat_bytes`` is the estimated fp32 size of the encoded
        feature this submodule emits. It only enters the cost model
        when the joint precision enumeration is armed — a remote
        candidate then pays the feature's return trip too (scaled by
        ``INT8_BYTES_SCALE`` for int8 candidates), which is what makes
        the quantized variant win exactly when the radio is the
        bottleneck. With ``precisions=None`` the estimate is the
        legacy uplink-only Δt, bit-identical to the precision-less
        rule."""
        q = queues or {}
        remotes = (self.remote_names if available is None
                   else [n for n in self.remote_names if n in available])
        if self.precisions is None:
            est = {self.local: TierEstimate(
                self.local, 0.0, q.get(self.local, 0.0),
                self.profile.time(submodule, self.tier_of[self.local]))}
            for n in remotes:
                est[n] = TierEstimate(
                    n, self.monitors[n].delta_t(payload_bytes, now),
                    q.get(n, 0.0),
                    self.profile.time(submodule, self.tier_of[n]))
        else:
            est = {}
            for host in (self.local, *remotes):
                t_fp32 = self.profile.time(submodule, self.tier_of[host])
                cands = []
                for prec in self.precisions.get(host, ("fp32",)):
                    scale = INT8_COMPUTE_SCALE if prec == "int8" else 1.0
                    if host == self.local:
                        xfer = 0.0
                    else:
                        fb = feat_bytes * (INT8_BYTES_SCALE
                                           if prec == "int8" else 1.0)
                        xfer = self.monitors[host].delta_t(
                            payload_bytes + fb, now)
                    cands.append(TierEstimate(
                        host, xfer, q.get(host, 0.0), t_fp32 * scale,
                        precision=prec))
                # per-tier argmin over precisions; ties keep fp32 (no
                # gratuitous quantization when bytes are not the bottleneck)
                est[host] = min(cands,
                                key=lambda e: (e.cost,
                                               e.precision != "fp32"))
        # tie-break toward local: the legacy rule offloads only on a
        # STRICT win (dt + te < tg)
        pick = self._pick(submodule, est, prefer=self.local)
        spec, margin = False, float("inf")
        if (self.speculation is not None and self.adaptive
                and self._forced(submodule) is None and remotes):
            margin = (self.speculation.deadline_s - lateness_s
                      - est[pick].cost)
            spec = self.speculation.should_speculate(est[pick].cost,
                                                     lateness_s)
        return TierDecision(tier=pick, local=self.local, estimates=est,
                            speculate=spec, margin_s=margin,
                            precision=est[pick].precision)

    def decide_tail(self, feat_bytes: int, out_bytes: int, enc_tier: str,
                    now: float, *, queues: "Dict[str, float] | None" = None,
                    available=None) -> TierDecision:
        """Place the fusion *tail* separately from the encoder that
        feeds it: candidate costs add the feature transfer from
        ``enc_tier`` (0 when co-located) and the head-output return trip
        to the local tier (0 when the tail runs locally). Ties prefer
        co-location with the encoder (no extra hop)."""
        q = queues or {}
        remotes = (self.remote_names if available is None
                   else [n for n in self.remote_names if n in available])
        cands = {self.local, *remotes}
        est = {}
        for k in cands:
            xfer = 0.0
            if k != enc_tier:
                xfer += feat_bytes / self.link_bw(enc_tier, k, now)
            if k != self.local:
                xfer += out_bytes / self.link_bw(k, self.local, now)
            est[k] = TierEstimate(
                k, xfer, q.get(k, 0.0),
                self.profile.time("tail", self.tier_of[k]))
        return TierDecision(tier=self._pick("tail", est, prefer=enc_tier),
                            local=self.local, estimates=est)
