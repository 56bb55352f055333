"""One EMSServe: the unified session engine, tiered half.

:class:`EMSServeEngine` serves many concurrent sessions over a
``SplitModel`` zoo. This port carries its tiered placement path, the
paper's own glass/phone/edge serving: every arrival is placed on a tier
per submodule on simulated tier clocks, through

  * :class:`PlacementPolicy` — N tier hosts on simulated busy-clocks
    (the legacy glass<->edge pair, or an ordered ``tiers`` list like
    ``("glass", "ph1", "edge64x")``), live per-arrival decisions through
    per-link heartbeat-quantized monitors with each host's queueing
    delay in the estimate, per-submodule placement (the fusion tail may
    run on another tier than its encoder), byte-accounted in-order
    per-link transport, heartbeat-detected crash failover from the
    versioned feature cache, tier restart/rejoin with replica re-warm,
    and the int8 precision rung: with ``precision={host: "int8"}`` the
    placement argmin enumerates (tier, precision) jointly, int8 flights
    run the encoders over the int8 sidecar parameters (through the
    hand-written quantize / int8 GEMM kernels) and ship the packed
    ``{"q", "scale"}`` feature, which the consuming tier dequantizes at
    gather time.

The simulated clock decides placement; the tensors are computed for real
on the engine's device (``cuda`` unless the caller asks for the CPU).

Built from a spec by :func:`build_engine`::

    eng = build_engine(models, params, "tiered", profile=table,
                       trace=trace, tiers=("glass", "ph1", "edge64x"),
                       precision={"ph1": "int8", "edge64x": "int8"},
                       share_encoders=True)

Not here yet, each raising ``NotImplementedError`` that names its
ROADMAP queue-1 item: the flush path (``batch``/``stream`` specs,
``flush``/``poll``/``drain``/``run_episodes``, ragged batching, glass
provisional partials — item 4) and chaos schedules (item 7). The other
robustness rungs of item 7, speculative dual placement and mid-flight
re-dispatch, have no option here until they are ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .. import device as _device
from ..core.episodes import Event, merge_arrivals
from ..core.feature_cache import FeatureCache
from ..core.offload import (INT8_COMPUTE_SCALE, BandwidthTrace,
                            HeartbeatMonitor, MultiTierPolicy, ProfileTable,
                            TierDecision)
from ..core.splitter import SplitModel, select_model
from ..models.quantized import dequantize_feature, quantize_feature
from ..obs import Metrics, Tracer
from .transport import TierFabric, payload_nbytes

__all__ = [
    "SessionView", "TieredRecord", "TierHost", "PlacementPolicy",
    "EngineSpec", "EMSServeEngine", "build_engine", "parse_spec",
    "spec_tokens",
]

_FLUSH_PATH = ("the flush path (batch/stream specs) is ROADMAP queue 1 "
               "item 4, not ported yet")

# the legacy two-tier pair's ProfileTable keys, the heartbeat period the
# monitors quantize bandwidth to (the paper samples every second), and
# each link's one-way latency
LEGACY_TIERS = ("glass", "edge4c")
HB_PERIOD_S = 1.0
LINK_LATENCY_S = 0.005


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is ROADMAP queue 1 {item}, not "
                              "ported yet")


# ======================================================================
# Exchange types
# ======================================================================

@dataclass
class SessionView:
    """Per-session state on the simulated episode clock."""
    sid: str
    inputs: Dict[str, object] = field(default_factory=dict)
    input_step: Dict[str, int] = field(default_factory=dict)
    step: int = 0
    t_last_activity: Optional[float] = None   # last emission
    ready_at: float = 0.0                     # per-session in-order processing
    records: List["TieredRecord"] = field(default_factory=list)
    t_first_arrival: Optional[float] = None   # survives record trimming
    t_first_emit: Optional[float] = None
    t_final_emit: Optional[float] = None


@dataclass
class TierHost:
    """One hardware tier with its own busy-until simulated clock."""
    name: str                   # display name ('glass' | 'edge' | 'ph1' ...)
    tier: str                   # key into ProfileTable.factors
    profile: ProfileTable
    free_at: float = 0.0
    busy_s: float = 0.0
    calls: int = 0
    tracer: Optional[Tracer] = None

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer.disabled

    def time(self, submodule: str) -> float:
        return self.profile.time(submodule, self.tier)

    def occupy(self, duration: float, t_start: float,
               label: Optional[str] = None) -> Tuple[float, float]:
        """Book ``duration`` seconds of compute no earlier than
        ``t_start``; returns (start, done) on the simulated clock."""
        start = max(t_start, self.free_at)
        done = start + duration
        self.free_at = done
        self.busy_s += duration
        self.calls += 1
        if self.tracer:
            self.tracer.span(label or f"compute@{self.name}", "compute",
                             start, done, track=f"host:{self.name}",
                             host=self.name, queued_s=start - t_start)
        return start, done


@dataclass
class _TierFault:
    """Crash / detection / restart state of one remote tier."""
    crash_at: Optional[float] = None     # when the box actually dies
    detect_at: Optional[float] = None    # first missed heartbeat after it
    rejoin_at: Optional[float] = None    # when a restarted box comes back
    dead: bool = False                   # the glasses KNOW it is gone


@dataclass
class TieredRecord:
    """Timeline of one arrival through tiered placement. ``tier`` names
    whichever host ran the encoder; per-submodule placement is broken out
    in ``enc_tier``/``tail_tier`` (the tail may run on a third host, or
    nowhere while the modality subset is incomplete)."""
    sid: str
    index: int
    modality: str
    model: Optional[str]
    tier: str                   # host that ran the encoder (bulk compute)
    kind: str                   # 'partial' | 'final'
    t_arrival: float
    t_start: float              # when the glasses picked the event up
    t_emit: float               # when the prediction reached the glasses
    uplink_s: float = 0.0       # payload + cache-sync transfer time
    downlink_s: float = 0.0     # feature + outputs return transfer time
    compute_s: float = 0.0
    fallback: bool = False      # a tier crashed mid-flight; re-ran on glass
    detect_s: float = 0.0       # stall waiting on missed-heartbeat detection
    decision: Optional[TierDecision] = None
    outputs: Optional[dict] = None
    enc_tier: Optional[str] = None
    tail_tier: Optional[str] = None             # None: no fusion ran
    tail_decision: Optional[TierDecision] = None
    # numeric precision the encoder flight ran at ("fp32" | "int8"): int8
    # means the sidecar-quantized encoder computed the feature and the
    # cache/wire carry its packed {"q", "scale"} form
    precision: str = "fp32"

    @property
    def latency_s(self) -> float:
        return self.t_emit - self.t_arrival


# ======================================================================
# Placement policy + spec
# ======================================================================

@dataclass
class PlacementPolicy:
    """Tier placement knobs — two named tiers by default (the historical
    glass<->edge pair), or an ordered N-tier list.

    ``profile`` is the one-time offline profiling result; ``trace``
    drives both the heartbeat monitors (decisions) and the transport
    links (true wire bandwidth). ``tiers`` is an ordered list of
    ``ProfileTable.factors`` keys whose FIRST entry is the local host
    (the glasses); each remote's link defaults to ``trace`` and can be
    overridden per host via ``tier_traces``. With ``tiers`` set,
    ``contention_aware`` (each host's work-queue delay enters its
    estimate) and ``tail_placement`` (the fusion tail is placed apart
    from its encoder) default on; without, both default off. ``force``
    pins placement (a host name, or ``{submodule: host}``);
    ``adaptive=False`` always offloads to the cheapest remote.

    ``precision`` (``{host: "int8"}``) arms the quantized rung: an int8
    candidate scales a tier's encoder compute by ``INT8_COMPUTE_SCALE``
    and its feature-return bytes by ``INT8_BYTES_SCALE`` in the estimate
    (``core.offload``); real flights ship the real packed bytes. ``None``
    or an all-fp32 map keeps the engine bit-identical to the
    precision-less one. Every model must declare a ``quantize_fn`` or the
    engine refuses to build."""
    profile: ProfileTable
    trace: BandwidthTrace
    tiers: Optional[Tuple[str, ...]] = None
    tier_traces: Optional[Dict[str, BandwidthTrace]] = None
    adaptive: bool = True
    force: Optional[Union[str, Dict[str, str]]] = None
    contention_aware: Optional[bool] = None     # None = on iff N-tier
    tail_placement: Optional[bool] = None       # None = on iff N-tier
    precision: Optional[Dict[str, str]] = None  # host -> "fp32" | "int8"


@dataclass
class EngineSpec:
    """A typed engine recipe, produced by :func:`parse_spec`."""
    placement: PlacementPolicy
    share_encoders: bool = False
    max_history: Optional[int] = 256


# ======================================================================
# The engine
# ======================================================================

class EMSServeEngine:
    """The multi-session serving runtime over a ``SplitModel`` zoo, with
    tiered placement.

    ``models``/``params`` are shared across sessions (one weight copy);
    params must already live on ``device``, and payloads are moved there.
    ``share_encoders=True`` is for zoos built by ``core.modular
    .emsnet_zoo`` whose subset models share one parameter dict: a
    feature is encoded once in total (cache keys are session-level)
    instead of once per consuming model (``"{sid}:{model}"`` keys).
    """

    def __init__(self, models: Dict[str, SplitModel],
                 params: Dict[str, dict], *,
                 placement: Optional[PlacementPolicy] = None,
                 share_encoders: bool = False,
                 max_history: Optional[int] = 256,
                 tracer: Optional[Tracer] = None, device="cuda"):
        if placement is None:
            raise NotImplementedError(_FLUSH_PATH)
        pp = placement
        self.device = _device.resolve(device)
        self.models = models
        self.params = params
        self.placement_policy = pp
        self.share_encoders = share_encoders
        self.max_history = max_history

        # ---- observability: one metrics registry for the whole stack
        # (engine + cache + transport), and a span tracer defaulting to
        # the falsy no-op
        self.metrics = Metrics()
        self.tracer = tracer if tracer is not None else Tracer.disabled
        self.metrics.gauge_fn("engine.sessions_live",
                              lambda: len(self.sessions))
        self.metrics.gauge_fn("cache.entries", lambda: len(self.cache))
        # source-step metadata of the most recent _gather, consumed by
        # the fuse trace point (tracer-gated; {} when tracing is off)
        self._last_consumed: dict = {}

        # ---- cross-incident eviction knobs (set by the stream policy,
        # ROADMAP item 4; None here keeps every session)
        self.idle_timeout_s: Optional[float] = None
        self.max_sessions: Optional[int] = None

        # ---- shared session/cache state
        self.cache = FeatureCache(max_staleness=1, metrics=self.metrics,
                                  tracer=self.tracer)
        self.sessions: Dict[str, SessionView] = {}
        # every modality ANY model consumes: a prediction fusing all of
        # them cannot be refined further -> tagged "final"
        self.full_set = frozenset(m for sm in models.values()
                                  for m in sm.modalities())
        self.events_total = 0

        # ---- placement policy -> tier hosts, link fabric, fault state
        self.records: List[TieredRecord] = []
        self.profile = pp.profile
        multi = pp.tiers is not None
        # host names double as ProfileTable factor keys in N-tier mode;
        # the legacy pair keeps its historical display names
        names = list(pp.tiers) if multi else ["glass", "edge"]
        keys = names if multi else list(LEGACY_TIERS)
        if len(names) < 2:
            raise ValueError("tiered placement needs the local host plus "
                             "at least one remote tier")
        self.local_name = names[0]
        self.hosts: Dict[str, TierHost] = {
            n: TierHost(n, k, pp.profile, tracer=self.tracer)
            for n, k in zip(names, keys)}
        self.remote_names = names[1:]
        traces = {n: (pp.tier_traces or {}).get(n, pp.trace)
                  for n in self.remote_names}
        self.monitors = {n: HeartbeatMonitor(traces[n], period=HB_PERIOD_S)
                         for n in self.remote_names}
        self.fabric = TierFabric(self.local_name, traces,
                                 latency_s=LINK_LATENCY_S,
                                 metrics=self.metrics, tracer=self.tracer)
        # ---- quantized rung: validate the precision map up front (a bad
        # host name or a zoo without quantize_fn is a configuration error,
        # not a first-decision surprise), then arm the joint (tier,
        # precision) enumeration only when some host serves int8 — an
        # all-fp32 map is the legacy bit-identical rule
        prec_cfg = dict(pp.precision or {})
        for h, p in prec_cfg.items():
            if h not in names or p not in ("fp32", "int8"):
                raise ValueError(
                    f"precision[{h!r}]={p!r}: unknown host or precision "
                    f"(hosts {sorted(names)}, precisions fp32/int8)")
        int8_hosts = sorted(h for h, p in prec_cfg.items() if p == "int8")
        if int8_hosts:
            for mname, sm in models.items():
                if sm.module.quantize_fn is None:
                    raise ValueError(
                        f"precision={prec_cfg} needs an int8 variant of "
                        f"every model; {mname!r} declares no quantize_fn")
        # float32 dict id() -> derived int8 sidecar dict: derived ONCE per
        # distinct parameter dict, so share_encoders zoos (one dict for
        # the whole zoo) quantize exactly once
        self._qparams_cache: Dict[int, dict] = {}
        self.policy = MultiTierPolicy(
            pp.profile, self.monitors, local=self.local_name,
            tier_of={n: h.tier for n, h in self.hosts.items()},
            adaptive=pp.adaptive, force=pp.force,
            precisions=({h: ("fp32", "int8") for h in int8_hosts}
                        if int8_hosts else None))
        # the fastest remote is the legacy 'edge' of the 2-tier surface
        self._primary = min(
            self.remote_names,
            key=lambda n: pp.profile.factors[self.hosts[n].tier])
        self.contention_aware = (multi if pp.contention_aware is None
                                 else pp.contention_aware)
        self.tail_placement = (multi if pp.tail_placement is None
                               else pp.tail_placement)
        # per-tier replica freshness: (cache key, modality) -> feature
        # VERSION that host holds (versions bump only on real re-encodes;
        # steps get re-stamped by every touch)
        self._replica_versions: Dict[str, Dict[Tuple[str, str], int]] = {
            n: {} for n in self.remote_names}
        self._faults: Dict[str, _TierFault] = {
            n: _TierFault() for n in self.remote_names}
        self._host_names = list(names)
        self._total_latency = 0.0

    # ---- counters (read-through to the registry)
    @property
    def evicted_count(self) -> int:
        return int(self.metrics.get("engine.evicted_sessions"))

    @property
    def fallback_count(self) -> int:
        return int(self.metrics.get("placement.fallbacks"))

    @property
    def rejoin_count(self) -> int:
        return int(self.metrics.get("placement.rejoins"))

    @property
    def place_counts(self) -> Dict[str, int]:
        return {n: int(self.metrics.get(f"placement.enc.{n}"))
                for n in self._host_names}

    @property
    def tail_counts(self) -> Dict[str, int]:
        return {n: int(self.metrics.get(f"placement.tail.{n}"))
                for n in self._host_names}

    # ------------------------------------------------------------ intake

    def session(self, sid: str) -> SessionView:
        st = self.sessions.get(sid)
        if st is None:
            st = self.sessions[sid] = SessionView(sid)
        return st

    def submit(self, sid: str, event: Event, payload, *,
               aggregate=None) -> "TieredRecord":
        """Record one arriving datum (a tensor or numpy array, moved to
        the engine's device) and process it end to end on the decided
        tiers; returns its :class:`TieredRecord`. ``aggregate(old, new)
        -> input`` merges it into the modality's aggregated input
        (default: replace)."""
        return self._submit_tiered(sid, event, payload, aggregate=aggregate)

    def _intake(self, sid: str, event: Event, payload,
                aggregate) -> SessionView:
        st = self.session(sid)
        st.step += 1
        m = event.modality
        payload = torch.as_tensor(payload, device=self.device)
        old = st.inputs.get(m)
        st.inputs[m] = aggregate(old, payload) if aggregate else payload
        st.input_step[m] = st.step
        self.events_total += 1
        return st

    def flush(self, *args, **kwargs):
        raise NotImplementedError(_FLUSH_PATH)

    poll = drain = run_episodes = flush

    def _cache_key(self, sid: str, model_name: str) -> str:
        return sid if self.share_encoders else f"{sid}:{model_name}"

    def _consumers(self, m: str):
        return [(n, sm) for n, sm in self.models.items()
                if m in sm.modalities()]

    # ---------------------------------------------------------- eviction

    def _evict(self, sid: str):
        keys = ([sid] if self.share_encoders
                else [f"{sid}:{n}" for n in self.models])
        for key in keys:
            self.cache.drop_session(key)
        # forget every tier replica's versions too: a re-created session
        # restarts its version counters at 0, and a stale high-water mark
        # would wrongly skip re-shipping features
        dropped = set(keys)
        for versions in self._replica_versions.values():
            for k in [k for k in versions if k[0] in dropped]:
                del versions[k]
        del self.sessions[sid]
        self.metrics.inc("engine.evicted_sessions")
        if self.tracer:
            self.tracer.instant("evict", "session", track="engine",
                                sid=sid, keys=keys)

    def evict_sessions(self, now: float) -> int:
        """Cross-incident eviction sweep on the simulated clock; returns
        how many sessions left. Idle timeout first, then LRU down to
        ``max_sessions``: least-recently-active leaves first. Per-arrival
        serving leaves nothing pending, so every session is evictable."""
        if self.idle_timeout_s is None and self.max_sessions is None:
            return 0
        evictable = list(self.sessions.values())
        n0 = self.evicted_count
        if self.idle_timeout_s is not None:
            for st in list(evictable):
                last = st.t_last_activity
                if last is not None and now - last >= self.idle_timeout_s:
                    self._evict(st.sid)
                    evictable.remove(st)
        if self.max_sessions is not None \
                and len(self.sessions) > self.max_sessions:
            evictable.sort(key=lambda st: st.t_last_activity or 0.0)
            excess = len(self.sessions) - self.max_sessions
            for st in evictable[:excess]:
                self._evict(st.sid)
        return self.evicted_count - n0

    # ==================================================================
    # Tiered placement path (per-arrival on the simulated tier clocks)
    # ==================================================================

    @property
    def glass(self) -> TierHost:
        return self.hosts[self.local_name]

    @property
    def uplink(self):
        return self.fabric.channel(self.local_name, self._primary)

    @property
    def downlink(self):
        return self.fabric.channel(self._primary, self.local_name)

    @property
    def crash_at(self) -> Optional[float]:
        return self._faults[self._primary].crash_at

    @property
    def detect_at(self) -> Optional[float]:
        return self._faults[self._primary].detect_at

    # ----- fault injection / detection / rejoin

    def inject_crash(self, t: float, tier: Optional[str] = None, *,
                     rejoin_at: Optional[float] = None):
        """Tier ``tier`` (default: the fastest remote) dies at simulated
        time ``t``. The glasses learn of it at the first missed heartbeat
        strictly after ``t``. With ``rejoin_at``, a restarted box comes
        back then: it re-warms its feature-cache replica from the
        glass-side versioned cache and is placement-eligible again."""
        tier = self._primary if tier is None else tier
        f = self._faults[tier]
        f.crash_at = t
        period = self.monitors[tier].period
        f.detect_at = (math.floor(t / period) + 1) * period
        if self.tracer:
            self.tracer.instant("crash.inject", "fault", t,
                                track=f"host:{tier}", tier=tier,
                                detect_at=f.detect_at, rejoin_at=rejoin_at)
        if rejoin_at is not None:
            self.schedule_rejoin(rejoin_at, tier)

    def inject_schedule(self, schedule):
        _later("chaos crash/rejoin schedules", "item 7")

    def schedule_rejoin(self, t: float, tier: Optional[str] = None):
        tier = self._primary if tier is None else tier
        f = self._faults[tier]
        if f.crash_at is not None and t <= f.crash_at:
            raise ValueError(f"rejoin at {t} precedes the crash at "
                             f"{f.crash_at}")
        f.rejoin_at = t

    def _mark_dead(self, tier: str):
        self._faults[tier].dead = True
        self._replica_versions[tier].clear()   # that replica is gone
        self.metrics.inc("fault.crashes_detected")
        if self.tracer:
            f = self._faults[tier]
            self.tracer.instant(
                "crash.detect", "fault",
                f.detect_at if f.detect_at is not None else self.tracer.now(),
                track=f"host:{tier}", tier=tier, crash_at=f.crash_at)

    def _rejoin(self, tier: str, t: float):
        """A restarted tier comes back: fresh fault state, a fresh busy
        clock, and a replica re-warm shipped from the glass-side
        versioned cache (one bulk message on its link at the rejoin
        instant), after which it is placement-eligible again."""
        self._faults[tier] = _TierFault()
        # a restarted box boots idle: anything still on its clock is
        # phantom occupancy from flights the crash already lost
        self.hosts[tier].free_at = t
        versions = self._replica_versions[tier]
        warm_b = 0
        for (key, m), e in self.cache.entries():
            if versions.get((key, m), -1) < e.version:
                warm_b += payload_nbytes(e.feature)
                versions[(key, m)] = e.version
        if warm_b:
            self.fabric.channel(self.local_name, tier).send(warm_b, t)
        self.metrics.inc("placement.rejoins")
        if self.tracer:
            self.tracer.instant("rejoin", "fault", t, track=f"host:{tier}",
                                tier=tier, warm_bytes=warm_b)

    def _usable_remotes(self, now: float) -> List[str]:
        """Remote tiers a decision made at ``now`` may target, applying
        any heartbeat detection or restart the clock has crossed."""
        out = []
        for n in self.remote_names:
            f = self._faults[n]
            if not f.dead and f.detect_at is not None and now >= f.detect_at:
                self._mark_dead(n)
            if f.dead and f.rejoin_at is not None and now >= f.rejoin_at:
                self._rejoin(n, f.rejoin_at)
            if not self._faults[n].dead:
                out.append(n)
        return out

    def _dies_before(self, tier: str, t: float) -> bool:
        """Does ``tier`` crash before simulated time ``t``? (A sender
        must survive through the END of its own transmission.)"""
        f = self._faults.get(tier)
        return f is not None and f.crash_at is not None and f.crash_at < t

    def _queues(self, now: float) -> Optional[Dict[str, float]]:
        """Per-host queueing delay feeding contention-aware decisions
        (None = the contention-blind paper rule)."""
        if not self.contention_aware:
            return None
        return {n: max(0.0, h.free_at - now) for n, h in self.hosts.items()}

    def _payload_bytes(self, m: str, payload) -> int:
        """Raw sensor bytes for the uplink: the module's declared size
        (audio clip / camera frame, not the tokenized tensor) when
        available, else the actual array bytes."""
        for _n, sm in self._consumers(m):
            b = sm.module.payload_bytes.get(m)
            if b:
                return b
        return payload_nbytes(payload)

    def _enc_duration(self, m: str, n_runners: int, host: TierHost,
                      precision: str = "fp32") -> float:
        """Simulated seconds the tier spends encoding modality ``m`` for
        ``n_runners`` consuming models: expensive text encoders run in
        parallel, cheap ones serially (paper Fig. 8-right). int8 flights
        scale by the SAME ``INT8_COMPUTE_SCALE`` the placement estimate
        used, so the decision and the booking agree."""
        per = host.time(f"enc:{m}")
        if precision == "int8":
            per *= INT8_COMPUTE_SCALE
        return per if m == "text" else per * n_runners

    def _feat_bytes_est(self, m: str) -> int:
        """A-priori float32 size of modality ``m``'s encoded feature (the
        declared feature width x 4 bytes): what the joint precision
        enumeration scales by ``INT8_BYTES_SCALE`` before the encoder has
        run. Real flights then ship the real packed bytes."""
        for _n, sm in self._consumers(m):
            d = sm.module.feature_dims.get(m)
            if d:
                return 4 * int(d)
        return 0

    # ----------------------------------------------------- real numerics
    #
    # Numerics are split into run / commit phases so the fault path can
    # execute the real calls (placement never changes the math) yet leave
    # the glass-side cache untouched when a tier dies before its result
    # makes it back.

    def _quantized_params(self, name: str) -> dict:
        """The int8 sidecar dict for model ``name``, derived lazily and
        cached per DISTINCT float32 dict (id()-keyed): a share_encoders
        zoo whose subsets all alias one dict quantizes once in total."""
        src = self.params[name]
        qp = self._qparams_cache.get(id(src))
        if qp is None:
            with torch.inference_mode():
                qp = self._qparams_cache[id(src)] = \
                    self.models[name].quantize_params(src)
        return qp

    def _run_encoders(self, st: SessionView, m: str,
                      precision: str = "fp32") -> Dict[str, object]:
        """Real encoder run(s) for the arriving modality; returns
        ``{model_name: feature}`` WITHOUT touching the cache. An int8
        flight runs the SAME encoder over the sidecar dict
        (``layers.dense`` dispatches on the leaf form) and returns the
        packed ``{"q", "scale"}`` wire form — what the cache commits and
        the downlink sizes."""
        consumers = self._consumers(m)
        if not consumers:
            return {}
        runners = consumers[:1] if self.share_encoders else consumers
        enc_in = st.inputs[m]
        with torch.inference_mode():
            if precision == "int8":
                return {name: quantize_feature(sm.encoders[m](
                            self._quantized_params(name), enc_in))
                        for name, sm in runners}
            return {name: sm.encoders[m](self.params[name], enc_in)
                    for name, sm in runners}

    def _tail(self, model_name: str, gathered):
        with torch.inference_mode():
            return self.models[model_name].tail(self.params[model_name],
                                                gathered)

    def _commit_features(self, st: SessionView, m: str, feats, tier: str):
        for name, feat in feats.items():
            self.cache.put(self._cache_key(st.sid, name), m, feat,
                           step=st.step, tier=tier)

    def _gather(self, st: SessionView, model_name: str, m: str, feats):
        """The selected model's input features — the arriving modality
        from the fresh (possibly uncommitted) ``feats``, everything else
        from the glass cache with the <=1-step staleness invariant
        asserted on every read. Packed int8 features (fresh or cached)
        unpack here, at the consuming tier. None while the subset is
        incomplete."""
        sm = self.models[model_name]
        key = self._cache_key(st.sid, model_name)
        fresh = (next(iter(feats.values()), None) if self.share_encoders
                 else feats.get(model_name))
        out, consumed = {}, {}
        with torch.inference_mode():
            for mm in sm.modalities():
                if mm == m and fresh is not None:
                    out[mm] = dequantize_feature(fresh)
                    # the fresh feature carries this very step; its
                    # commit lands before the fuse is recorded
                    consumed[mm] = [st.step, st.input_step.get(mm, st.step)]
                    continue
                e = self.cache.get(key, mm, input_step=st.input_step.get(mm))
                if e is None:
                    return None
                out[mm] = dequantize_feature(e.feature)
                consumed[mm] = [e.step, st.input_step.get(mm, e.step)]
        if self.tracer:
            self._last_consumed = consumed
        return out

    def _touch_consumed(self, st: SessionView, model_name: str):
        """The result carries the cache back (paper fault tolerance):
        re-stamp every consumed entry at this step."""
        key = self._cache_key(st.sid, model_name)
        for mm in self.models[model_name].modalities():
            self.cache.touch(key, mm, st.step)

    # ------------------------------------------------------------- event

    def _submit_tiered(self, sid: str, event: Event, payload, *,
                       aggregate=None) -> TieredRecord:
        """Process one arriving datum end to end: decide a tier per
        submodule, encode there, transport, re-fuse, emit on glass."""
        st = self._intake(sid, event, payload, aggregate)
        t_a = event.arrival_time
        if st.t_first_arrival is None:
            st.t_first_arrival = t_a
        now = max(t_a, st.ready_at)
        sess = f"session:{sid}"
        if self.tracer:
            self.tracer.set_time(now)
            self.tracer.instant("arrival", "arrival", t_a, track=sess,
                                sid=sid, index=event.index,
                                modality=event.modality, step=st.step)
            if now > t_a:
                # per-session in-order processing: this arrival waits for
                # the previous record's emit
                self.tracer.span("queue.wait", "queue", t_a, now,
                                 track=sess, sid=sid, index=event.index)
        model_name = select_model(self.models, st.inputs)
        payload_b = self._payload_bytes(event.modality,
                                        st.inputs[event.modality])
        avail = self._usable_remotes(now)
        queues = self._queues(now)
        dec = self.policy.decide(f"enc:{event.modality}", payload_b, now,
                                 queues=queues, available=avail,
                                 feat_bytes=self._feat_bytes_est(
                                     event.modality))
        if self.tracer:
            # the precision attr only appears when the joint rung is
            # armed, so precision-less traces stay byte-identical
            extra = ({"precision": dec.precision}
                     if self.policy.precisions is not None else {})
            self.tracer.instant("decide", "placement", now, track=sess,
                                sid=sid, submodule=f"enc:{event.modality}",
                                tier=dec.tier, best_remote=dec.best_remote,
                                **extra)

        if self.tail_placement:
            rec = self._placed_event(st, event, model_name, payload_b, now,
                                     dec, avail, queues)
        elif dec.tier != self.local_name:
            rec = self._remote_event(st, event, model_name, payload_b, now,
                                     dec, dec.tier)
        else:
            rec = self._glass_event(st, event, model_name, now, dec)

        st.ready_at = rec.t_emit
        st.t_last_activity = rec.t_emit        # simulated clock
        st.records.append(rec)
        self.records.append(rec)
        if self.max_history is not None:
            del st.records[:-self.max_history]
            del self.records[:-self.max_history]
        self._total_latency += rec.latency_s
        self.metrics.observe("serve.latency_s", rec.latency_s)
        if self.tracer:
            self.tracer.span(
                f"{rec.modality}#{rec.index}", "lifecycle", rec.t_arrival,
                rec.t_emit, track=sess, sid=sid, index=rec.index,
                modality=rec.modality, enc_tier=rec.enc_tier,
                tail_tier=rec.tail_tier, kind=rec.kind,
                fallback=rec.fallback, detect_s=rec.detect_s)
        if rec.outputs is not None:
            if st.t_first_emit is None:
                st.t_first_emit = rec.t_emit
                self.metrics.observe("serve.ttfp_s",
                                     rec.t_emit - st.t_first_arrival)
            if rec.kind == "final" and st.t_final_emit is None:
                st.t_final_emit = rec.t_emit
            if self.tracer:
                key = self._cache_key(sid, rec.model)
                self.tracer.instant(
                    "fuse", "fusion", rec.t_emit, track=sess, sid=sid,
                    key=key, model=rec.model, step=st.step,
                    consumed=self._last_consumed)
                self.tracer.instant(
                    "emit", "predict", rec.t_emit, track=sess, sid=sid,
                    key=key, model=rec.model, step=st.step, kind=rec.kind,
                    modalities=sorted(self.models[rec.model].modalities()))
        self.evict_sessions(rec.t_emit)
        return rec

    def _kind(self, model_name: Optional[str]) -> str:
        if model_name is None:
            return "partial"
        mods = frozenset(self.models[model_name].modalities())
        return "final" if mods == self.full_set else "partial"

    def _sync_bytes(self, tier: str, st: SessionView,
                    model_name: Optional[str], *, skip: str):
        """Bytes needed to bring ``tier``'s replica up to date on every
        cached feature the selected model consumes (except ``skip``, the
        freshly arriving modality), plus the (replica key, version) pairs
        to stamp once the path succeeds."""
        sync_b, synced = 0, []
        if model_name is not None:
            versions = self._replica_versions[tier]
            key = self._cache_key(st.sid, model_name)
            for mm in self.models[model_name].modalities():
                if mm == skip:
                    continue
                e = self.cache.peek(key, mm)
                if e is not None and versions.get((key, mm), -1) < e.version:
                    sync_b += payload_nbytes(e.feature)
                    synced.append(((key, mm), e.version))
        return sync_b, synced

    def _stamp_fresh(self, tier: str, st: SessionView, m: str):
        """``tier``'s replica now holds the fresh feature(s) of ``m``."""
        versions = self._replica_versions[tier]
        for name in self.models:
            key = self._cache_key(st.sid, name)
            e = self.cache.peek(key, m)
            if e is not None:
                versions[(key, m)] = e.version

    def _crash_fallback(self, tier: str, st: SessionView, event: Event,
                        model_name: Optional[str], now: float,
                        dec: TierDecision, *, feats=None,
                        outputs=None) -> TieredRecord:
        """A remote participant died before its transmission completed:
        mark it dead at the first missed heartbeat, then re-run the lost
        flight on glass. The already-computed numerics are reused:
        placement never changes the math, so the re-run's tensors are the
        in-flight ones (and keep the flight's precision)."""
        t_detect = max(now, self._faults[tier].detect_at)
        self._mark_dead(tier)
        return self._glass_event(st, event, model_name, t_detect, dec,
                                 fallback=True,
                                 detect_s=max(0.0, t_detect - now),
                                 feats=feats, outputs=outputs)

    def _glass_event(self, st: SessionView, event: Event,
                     model_name: Optional[str], now: float,
                     dec: TierDecision, *, fallback: bool = False,
                     detect_s: float = 0.0, feats=None,
                     outputs=None) -> TieredRecord:
        m = event.modality
        local = self.local_name
        if feats is None:
            feats = self._run_encoders(st, m, dec.precision)
        self._commit_features(st, m, feats, tier=local)
        if outputs is None and model_name is not None:
            gathered = self._gather(st, model_name, m, feats)
            if gathered is not None:
                outputs = self._tail(model_name, gathered)
        if outputs is not None:
            self._touch_consumed(st, model_name)
        dur = (self._enc_duration(m, len(feats), self.glass, dec.precision)
               if feats else 0.0)
        if outputs is not None:
            dur += self.glass.time("tail")
        start, done = self.glass.occupy(dur, now)
        self.metrics.inc("placement.on_glass")
        self.metrics.inc(f"placement.enc.{local}")
        if outputs is not None:
            self.metrics.inc(f"placement.tail.{local}")
        if fallback:
            self.metrics.inc("placement.fallbacks")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=local, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=start, t_emit=done,
            compute_s=dur, fallback=fallback, detect_s=detect_s,
            decision=dec, outputs=outputs, enc_tier=local,
            tail_tier=local if outputs is not None else None,
            precision=dec.precision)

    def _remote_event(self, st: SessionView, event: Event,
                      model_name: Optional[str], payload_b: int,
                      now: float, dec: TierDecision, A: str, *,
                      feats=None, outputs=None) -> TieredRecord:
        """Encoder AND tail on remote tier ``A`` (the co-located path —
        with ``tail_placement`` off this is the only remote shape)."""
        m = event.modality
        host = self.hosts[A]
        up_ch = self.fabric.channel(self.local_name, A)
        down_ch = self.fabric.channel(A, self.local_name)
        # ---- uplink: raw payload + any features this replica lacks
        sync_b, synced = self._sync_bytes(A, st, model_name, skip=m)
        up = up_ch.send(payload_b + sync_b, now)

        # ---- real numerics (uncommitted) + simulated remote compute
        if feats is None:
            feats = self._run_encoders(st, m, dec.precision)
            if model_name is not None:
                gathered = self._gather(st, model_name, m, feats)
                if gathered is not None:
                    outputs = self._tail(model_name, gathered)
        dur = (self._enc_duration(m, len(feats), host, dec.precision)
               if feats else 0.0)
        if outputs is not None:
            dur += host.time("tail")
        _start, t_done = host.occupy(dur, up.t_deliver)

        # ---- downlink payload: fresh feature(s) + head outputs
        down_b = sum(payload_nbytes(f) for f in feats.values())
        if outputs is not None:
            down_b += payload_nbytes(outputs)

        # ---- crash window: the tier must survive through the END of its
        # downlink transmission, not just its compute
        if self._dies_before(A, down_ch.eta(down_b, t_done)):
            return self._crash_fallback(A, st, event, model_name, now, dec,
                                        feats=feats, outputs=outputs)

        # ---- success: commit to the glass cache, ship the bytes
        self._commit_features(st, m, feats, tier=A)
        if outputs is not None:
            self._touch_consumed(st, model_name)
        down = down_ch.send(down_b, t_done)
        # the replica now holds everything it consumed or produced
        versions = self._replica_versions[A]
        for k, version in synced:
            versions[k] = version
        self._stamp_fresh(A, st, m)
        self.metrics.inc("placement.offloaded")
        self.metrics.inc(f"placement.enc.{A}")
        if outputs is not None:
            self.metrics.inc(f"placement.tail.{A}")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=A, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=up.t_send,
            t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
            downlink_s=down.t_deliver - t_done, compute_s=dur,
            decision=dec, outputs=outputs, enc_tier=A,
            tail_tier=A if outputs is not None else None,
            precision=dec.precision)

    # ------------------------------------------- per-submodule placement

    def _placed_event(self, st: SessionView, event: Event,
                      model_name: Optional[str], payload_b: int,
                      now: float, dec: TierDecision, avail,
                      queues) -> TieredRecord:
        """Per-submodule placement: the encoder goes to ``dec.tier``;
        when a fusion will run, the tail gets its OWN argmin placement
        (possibly a third host), paying the feature hop between the two
        and the head-output return to the glasses."""
        m = event.modality
        A = dec.tier
        # will a fusion actually run? (fresh feature for m, every other
        # consumed modality already cached)
        fusible = False
        if model_name is not None:
            have_fresh = bool(self._consumers(m))
            key = self._cache_key(st.sid, model_name)
            fusible = all((mm == m and have_fresh)
                          or self.cache.peek(key, mm) is not None
                          for mm in self.models[model_name].modalities())
        if not fusible:
            if A == self.local_name:
                return self._glass_event(st, event, model_name, now, dec)
            return self._remote_event(st, event, model_name, payload_b,
                                      now, dec, A)
        # real numerics first: the tail decision weighs the ACTUAL
        # feature/output byte sizes — for an int8 flight the PACKED form
        feats = self._run_encoders(st, m, dec.precision)
        gathered = self._gather(st, model_name, m, feats)
        if gathered is None:
            if A == self.local_name:
                return self._glass_event(st, event, model_name, now, dec,
                                         feats=feats)
            return self._remote_event(st, event, model_name, payload_b,
                                      now, dec, A, feats=feats)
        outputs = self._tail(model_name, gathered)
        feat_b = sum(payload_nbytes(f) for f in feats.values())
        out_b = payload_nbytes(outputs)
        dtail = self.policy.decide_tail(feat_b, out_b, A, now,
                                        queues=queues, available=avail)
        T = dtail.tier
        if T == A:
            if A == self.local_name:
                rec = self._glass_event(st, event, model_name, now, dec,
                                        feats=feats, outputs=outputs)
            else:
                rec = self._remote_event(st, event, model_name, payload_b,
                                         now, dec, A, feats=feats,
                                         outputs=outputs)
        else:
            rec = self._split_event(st, event, model_name, payload_b, now,
                                    dec, A, T, feats, outputs, feat_b, out_b)
        rec.tail_decision = dtail
        return rec

    def _split_event(self, st: SessionView, event: Event, model_name: str,
                     payload_b: int, now: float, dec: TierDecision,
                     A: str, T: str, feats, outputs, feat_b: int,
                     out_b: int) -> TieredRecord:
        """Encoder on ``A``, tail on a different tier ``T``. The fresh
        features always flow home to the glasses with the result (the
        paper's cache-carrying discipline), whichever tier computed them;
        commit stays on-success so a mid-flight death loses the in-flight
        work, never corrupts the cache."""
        m = event.modality
        local = self.local_name

        if A == local:
            # encoder at home; only the tail travels
            enc_dur = (self._enc_duration(m, len(feats), self.glass,
                                          dec.precision) if feats else 0.0)
            start, t_enc_done = self.glass.occupy(enc_dur, now)
            # glass-computed features are already safe at home
            self._commit_features(st, m, feats, tier=local)
            sync_b, synced = self._sync_bytes(T, st, model_name, skip=m)
            up = self.fabric.channel(local, T).send(feat_b + sync_b,
                                                    t_enc_done)
            tail_host = self.hosts[T]
            _s, t_tail_done = tail_host.occupy(tail_host.time("tail"),
                                               up.t_deliver)
            down_ch = self.fabric.channel(T, local)
            if self._dies_before(T, down_ch.eta(out_b, t_tail_done)):
                # tail-only fallback: features survived on glass
                t_detect = max(t_enc_done, self._faults[T].detect_at)
                self._mark_dead(T)
                _s2, done = self.glass.occupy(self.glass.time("tail"),
                                              t_detect)
                self._touch_consumed(st, model_name)
                self.metrics.inc("placement.on_glass")
                self.metrics.inc("placement.fallbacks")
                self.metrics.inc(f"placement.enc.{local}")
                self.metrics.inc(f"placement.tail.{local}")
                return TieredRecord(
                    sid=st.sid, index=event.index, modality=m,
                    model=model_name, tier=local,
                    kind=self._kind(model_name),
                    t_arrival=event.arrival_time, t_start=start,
                    t_emit=done, uplink_s=up.t_deliver - up.t_send,
                    compute_s=enc_dur + self.glass.time("tail"),
                    fallback=True,
                    detect_s=max(0.0, t_detect - t_enc_done),
                    decision=dec, outputs=outputs, enc_tier=local,
                    tail_tier=local, precision=dec.precision)
            down = down_ch.send(out_b, t_tail_done)
            self._touch_consumed(st, model_name)
            versions = self._replica_versions[T]
            for k, version in synced:
                versions[k] = version
            self._stamp_fresh(T, st, m)
            self.metrics.inc("placement.on_glass")
            self.metrics.inc(f"placement.enc.{local}")
            self.metrics.inc(f"placement.tail.{T}")
            return TieredRecord(
                sid=st.sid, index=event.index, modality=m,
                model=model_name, tier=local, kind=self._kind(model_name),
                t_arrival=event.arrival_time, t_start=start,
                t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
                downlink_s=down.t_deliver - t_tail_done,
                compute_s=enc_dur + tail_host.time("tail"),
                decision=dec, outputs=outputs, enc_tier=local,
                tail_tier=T, precision=dec.precision)

        host = self.hosts[A]
        up = self.fabric.channel(local, A).send(payload_b, now)
        enc_dur = (self._enc_duration(m, len(feats), host, dec.precision)
                   if feats else 0.0)
        _s, t_enc_done = host.occupy(enc_dur, up.t_deliver)

        if T == local:
            # features come home, fusion runs on the glasses
            down_ch = self.fabric.channel(A, local)
            if self._dies_before(A, down_ch.eta(feat_b, t_enc_done)):
                return self._crash_fallback(A, st, event, model_name, now,
                                            dec, feats=feats,
                                            outputs=outputs)
            down = down_ch.send(feat_b, t_enc_done)
            self._commit_features(st, m, feats, tier=A)
            self._stamp_fresh(A, st, m)
            _s2, done = self.glass.occupy(self.glass.time("tail"),
                                          down.t_deliver)
            self._touch_consumed(st, model_name)
            self.metrics.inc("placement.offloaded")
            self.metrics.inc(f"placement.enc.{A}")
            self.metrics.inc(f"placement.tail.{local}")
            return TieredRecord(
                sid=st.sid, index=event.index, modality=m,
                model=model_name, tier=A, kind=self._kind(model_name),
                t_arrival=event.arrival_time, t_start=up.t_send,
                t_emit=done, uplink_s=up.t_deliver - up.t_send,
                downlink_s=down.t_deliver - t_enc_done,
                compute_s=enc_dur + self.glass.time("tail"),
                decision=dec, outputs=outputs, enc_tier=A,
                tail_tier=local, precision=dec.precision)

        # encoder on A, tail on another remote B: the feature hops A->B on
        # the direct link while the glasses warm B's replica in parallel;
        # B returns features + outputs home
        B = T
        sync_b, synced = self._sync_bytes(B, st, model_name, skip=m)
        sync_d = (self.fabric.channel(local, B).send(sync_b, now)
                  if sync_b else None)
        hop_ch = self.fabric.channel(A, B)
        if self._dies_before(A, hop_ch.eta(feat_b, t_enc_done)):
            return self._crash_fallback(A, st, event, model_name, now, dec,
                                        feats=feats, outputs=outputs)
        hop = hop_ch.send(feat_b, t_enc_done)
        ready = max(hop.t_deliver,
                    sync_d.t_deliver if sync_d is not None else 0.0)
        tail_host = self.hosts[B]
        _s2, t_tail_done = tail_host.occupy(tail_host.time("tail"), ready)
        down_ch = self.fabric.channel(B, local)
        down_b = feat_b + out_b         # the result carries the cache home
        if self._dies_before(B, down_ch.eta(down_b, t_tail_done)):
            return self._crash_fallback(B, st, event, model_name, now, dec,
                                        feats=feats, outputs=outputs)
        down = down_ch.send(down_b, t_tail_done)
        self._commit_features(st, m, feats, tier=A)
        self._touch_consumed(st, model_name)
        versions = self._replica_versions[B]
        for k, version in synced:
            versions[k] = version
        self._stamp_fresh(A, st, m)
        self._stamp_fresh(B, st, m)
        self.metrics.inc("placement.offloaded")
        self.metrics.inc(f"placement.enc.{A}")
        self.metrics.inc(f"placement.tail.{B}")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=A, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=up.t_send,
            t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
            downlink_s=down.t_deliver - t_tail_done,
            compute_s=enc_dur + tail_host.time("tail"),
            decision=dec, outputs=outputs, enc_tier=A, tail_tier=B,
            precision=dec.precision)

    # --------------------------------------------------------- episodes

    def run_arrivals(self, episodes: Dict[str, List[Event]], payload_fn,
                     *, aggregate=None, crash_at: Optional[float] = None,
                     rejoin_at: Optional[float] = None, schedule=None):
        """Drive sessions through their episodes in GLOBAL arrival-time
        order (``core.episodes.merge_arrivals``), one arrival at a time,
        optionally killing the fastest remote at simulated time
        ``crash_at`` (restarted at ``rejoin_at``); returns the records.
        ``payload_fn(sid, event) -> payload``."""
        if schedule is not None:
            self.inject_schedule(schedule)
        if crash_at is not None:
            self.inject_crash(crash_at, rejoin_at=rejoin_at)
        elif rejoin_at is not None:
            raise ValueError("rejoin_at requires crash_at")
        for _t, sid, ev in merge_arrivals(episodes):
            self.submit(sid, ev, payload_fn(sid, ev), aggregate=aggregate)
        return self.records

    # ------------------------------------------------------------- stats

    def compile_count(self) -> int:
        return sum(sm.compile_count() for sm in self.models.values())

    def time_to_first_prediction(self, sid: str) -> Optional[float]:
        """Simulated seconds from a session's first arrival to its first
        emission."""
        st = self.sessions[sid]
        if st.t_first_emit is None or st.t_first_arrival is None:
            return None
        return st.t_first_emit - st.t_first_arrival

    def time_to_final_prediction(self, sid: str) -> Optional[float]:
        st = self.sessions[sid]
        if st.t_final_emit is None or st.t_first_arrival is None:
            return None
        return st.t_final_emit - st.t_first_arrival

    def total_latency_s(self) -> float:
        """Cumulative serving latency (sum of per-arrival t_emit -
        t_arrival) — the Fig. 15 comparison metric."""
        return self._total_latency

    def makespan_s(self) -> float:
        return max((r.t_emit for r in self.records), default=0.0)

    def transport_stats(self) -> dict:
        """Per-link byte accounting: ``uplink``/``downlink`` for the
        glass<->fastest-remote pair, ``links`` for every (src, dst)
        channel the fabric used."""
        return {"uplink": self.uplink.stats(),
                "downlink": self.downlink.stats(),
                "links": self.fabric.stats()}

    def placement_counts(self) -> dict:
        """Events placed per host (by ENCODER tier), plus crash
        fallbacks."""
        return {**self.place_counts, "fallbacks": self.fallback_count}

    def tail_placement_counts(self) -> dict:
        """Fusions run per host."""
        return dict(self.tail_counts)


# ======================================================================
# Spec parsing + factory
# ======================================================================

_SPEC_TOKENS = {
    "batch": "batch", "batched": "batch",
    "stream": "stream", "streaming": "stream",
    "tiered": "tiered", "tier": "tiered", "placement": "tiered",
}
_ENGINE_KEYS = ("share_encoders", "max_history")


def spec_tokens(spec: str) -> Tuple[str, ...]:
    """The canonical policy tokens of a '+'-joined spec string, in order
    and without repeats; an unknown token raises ``ValueError``."""
    toks: List[str] = []
    for tok in filter(None, (t.strip() for t in spec.split("+"))):
        canon = _SPEC_TOKENS.get(tok.lower())
        if canon is None:
            raise ValueError(f"unknown engine spec token {tok!r}; expected "
                             f"'+'-joined subset of batch/stream/tiered")
        if canon not in toks:
            toks.append(canon)
    return tuple(toks)


def parse_spec(spec, **overrides) -> EngineSpec:
    """Normalise an engine spec into a typed :class:`EngineSpec`.

    ``spec`` is a string of '+'-joined policy tokens, a dict with a
    ``tiered`` section (True or a kwargs dict) plus engine-wide keys
    ``share_encoders``/``max_history``, or an :class:`EngineSpec`
    (returned as-is). ``overrides`` go to the engine or to
    :class:`PlacementPolicy` by name and beat the same key in a dict
    section. Tiered specs REQUIRE ``profile`` and ``trace``. The
    ``batch`` and ``stream`` policies raise ``NotImplementedError``."""
    if isinstance(spec, EngineSpec):
        if overrides:
            raise ValueError("overrides are not applied to a pre-built "
                             "EngineSpec; pass tokens or a dict instead")
        return spec
    sections: Dict[str, dict] = {}
    engine_kw: Dict[str, Any] = {}
    if isinstance(spec, str):
        sections = {canon: {} for canon in spec_tokens(spec)}
    elif isinstance(spec, dict):
        for key, val in spec.items():
            if key in _ENGINE_KEYS:
                engine_kw[key] = val
                continue
            canon = _SPEC_TOKENS.get(str(key).lower())
            if canon is None:
                raise ValueError(f"unknown engine spec section {key!r}")
            if val is False or val is None:
                continue
            sections[canon] = {} if val is True else dict(val)
    else:
        raise TypeError(f"engine spec must be str, dict, or EngineSpec; "
                        f"got {type(spec).__name__}")
    if not sections:
        raise ValueError("empty engine spec: enable at least one of "
                         "batch/stream/tiered")
    if set(sections) - {"tiered"}:
        raise NotImplementedError(_FLUSH_PATH)

    fields = set(PlacementPolicy.__dataclass_fields__)
    kw = sections["tiered"]
    for k, v in overrides.items():
        if k in _ENGINE_KEYS:
            engine_kw[k] = v
        elif k in fields:
            kw[k] = v                 # overrides WIN over dict-spec values
        else:
            raise ValueError(f"override {k!r} does not match any enabled "
                             "policy (tiered)")
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown tiered policy option(s): "
                         f"{sorted(unknown)}")
    if not {"profile", "trace"} <= set(kw):
        raise ValueError("tiered placement requires 'profile' "
                         "(ProfileTable) and 'trace' (BandwidthTrace)")
    return EngineSpec(placement=PlacementPolicy(**kw), **engine_kw)


def build_engine(models: Dict[str, SplitModel], params: Dict[str, dict],
                 spec, *, tracer: Optional[Tracer] = None, device="cuda",
                 **overrides) -> EMSServeEngine:
    """THE factory: assemble an :class:`EMSServeEngine` from a spec (see
    :func:`parse_spec`). ``tracer`` turns on full-lifecycle span tracing;
    ``device`` is where the params live and the tensors are computed."""
    es = parse_spec(spec, **overrides)
    return EMSServeEngine(models, params, placement=es.placement,
                          share_encoders=es.share_encoders,
                          max_history=es.max_history, tracer=tracer,
                          device=device)
