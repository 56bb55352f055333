"""Region simulator: N engine replicas from ONE spec, open-loop driven.

The fleet story in one file:

  * **One spec, N replicas** — ``RegionSim`` builds every replica with
    the same ``build_engine`` spec string over the same placed parameter
    dicts. ``fleet_mesh``/``place_fleet_params`` read the sharding
    ``Policy`` (``distributed.sharding``) over a ``('data', 'model')``
    mesh of the visible CUDA devices. The EMSNet dicts have no
    tensor-parallel use ('model' is 1 on every mesh built here), so each
    leaf lands whole: one weight copy per device, which *is* the replica
    story. Names sharing one dict keep sharing it, so the
    ``share_encoders`` grouped-tail fast path keeps working.

  * **Shared simulated clock** — arrivals are replayed in global fleet
    time; each replica carries a serving clock that can never run ahead
    of data availability: a flush over everything pending starts at
    ``max(replica_clock, oldest_pending_arrival)`` and costs the
    *measured wall time* of the real batched calls (on the card, up to
    and including the flush's one ``torch.cuda.synchronize``, so a CUDA
    graph captured inside a flush lands on the clock as service time).
    Backlog is the gap ``replica_clock - now`` — exactly the quantity
    open-loop queueing blows up.

  * **Routing** — ``ConsistentHashRouter``: sessions hash onto a vnode
    ring (stable under replica-count changes), with a least-loaded
    spill when the home replica's backlog exceeds the fleet minimum by
    ``spill_s``.

  * **Shedding** — an ``admission.AdmissionController`` gates NEW
    sessions; shed sessions are served by ``GlassShedPath``: the
    on-glass provisional path (the same degradation ``stream+tiered``
    uses mid-offload) on per-session glass clocks timed from the
    ``ProfileTable`` glass tier. Degraded sessions emit ONLY
    ``kind="partial"`` predictions tagged ``degraded=True`` — counted,
    never silently dropped — and touch no replica backlog.

An admitted session's finals equal those of a per-event engine built
with the same fixed batch bucket: coalescing changes which rows share a
call, not the rows' arithmetic.
"""
from __future__ import annotations

import bisect
import hashlib
import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core.splitter import select_model
from ..distributed.sharding import Policy
from ..obs import Metrics
from ..serving.api import build_engine
from ..training.tree import paths, tree_map
from .admission import AdmitAll
from .workload import IncidentSession, merge_sessions

__all__ = ["FleetMesh", "fleet_mesh", "place_fleet_params",
           "ConsistentHashRouter", "DegradedRecord", "GlassShedPath",
           "RegionSim"]


# ------------------------------------------------------------------ mesh

@dataclass(frozen=True)
class FleetMesh:
    """A ``('data', 'model')`` grid of torch devices: ``devices`` is an
    object array shaped ``(data, model)``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")


def fleet_mesh(n_replicas: Optional[int] = None, device="cuda") -> FleetMesh:
    """A ('data', 'model') mesh over the visible CUDA devices (at most
    ``n_replicas`` of them; 'model' is size 1 — no tensor parallelism in
    the EMSNet zoo), or over the one CPU when ``device="cpu"``. Asking
    for CUDA without a card raises."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    n = len(devs) if n_replicas is None else max(1, min(n_replicas,
                                                        len(devs)))
    grid = np.empty((n, 1), dtype=object)
    for i in range(n):
        grid[i, 0] = devs[i]
    return FleetMesh(grid)


def place_fleet_params(params: Dict[str, dict], mesh: FleetMesh, *,
                       cfg=None, strategy: str = "2d"):
    """Place the engine parameter dicts on ``mesh`` through the
    ``distributed.sharding.Policy`` specs.

    ``params`` maps model name -> parameter dict; names sharing ONE dict
    (the subset zoo) are placed once and keep sharing it, so the
    engine's ``share_encoders`` grouped-tail identity check still holds.
    'model' is 1 on every mesh ``fleet_mesh`` builds, so a leaf with a
    'model' spec lands whole; a mesh that would split a leaf raises.
    The placed dicts live on the mesh's first device; ``RegionSim(...,
    mesh=mesh)`` gives replica ``r`` a copy on device ``r % n``, made
    once per device. That multi-card path has run on no machine with
    more than one card yet. Returns ``(placed_params, report)``, the
    report counting replicated against sharded leaves and total
    bytes."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if sizes.get("model", 1) != 1:
        raise ValueError(f"mesh has model={sizes['model']}: the fleet "
                         "places whole replicas and splits no leaf")
    pol = Policy(cfg, mesh, strategy=strategy)
    leaves_total = sharded = 0
    nbytes = 0
    for p in {id(p): p for p in params.values()}.values():
        for path, leaf in paths(p):
            leaves_total += 1
            if any(a is not None for a in pol.param_spec(path, leaf)):
                sharded += 1
            nbytes += leaf.numel() * leaf.element_size()
    report = {
        "devices": len(mesh.devices.reshape(-1)),
        "axis_sizes": {k: int(v) for k, v in sizes.items()},
        "strategy": strategy,
        "param_leaves": leaves_total,
        "sharded_leaves": sharded,
        "replicated_leaves": leaves_total - sharded,
        "param_bytes": int(nbytes),
    }
    return _copy_shared(params, mesh.devices.reshape(-1)[0]), report


# ---------------------------------------------------------------- router

def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(),
                                          digest_size=8).digest(), "big")


class ConsistentHashRouter:
    """Consistent-hash session->replica ring with a least-loaded spill.

    Each replica owns ``vnodes`` points on a 64-bit ring; a session id
    hashes to the next point clockwise (stable when replicas are added
    or removed — only ~1/N of sessions move). When per-replica loads
    are supplied and the home replica's load exceeds the fleet minimum
    by more than ``spill_s`` seconds, the session routes to the
    least-loaded replica instead (ties to the lowest index)."""

    def __init__(self, n_replicas: int, *, vnodes: int = 64, seed: int = 0,
                 spill_s: float = 0.05):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas
        self.spill_s = spill_s
        self._seed = seed
        ring = [(_hash64(f"{seed}:{r}:{v}"), r)
                for r in range(n_replicas) for v in range(vnodes)]
        ring.sort()
        self._points = [p for p, _ in ring]
        self._owners = [r for _, r in ring]
        self.spills = 0

    def home(self, sid: str) -> int:
        h = _hash64(f"{self._seed}:{sid}")
        i = bisect.bisect_right(self._points, h) % len(self._points)
        return self._owners[i]

    def route(self, sid: str,
              loads: Optional[Sequence[float]] = None) -> int:
        r = self.home(sid)
        if loads is None:
            return r
        if len(loads) != self.n_replicas:
            raise ValueError(f"loads has {len(loads)} entries for "
                             f"{self.n_replicas} replicas")
        least = min(range(self.n_replicas), key=lambda i: (loads[i], i))
        if loads[r] - loads[least] > self.spill_s:
            self.spills += 1
            return least
        return r


# ------------------------------------------------------------ glass path

@dataclass(frozen=True)
class DegradedRecord:
    """One on-glass provisional emission for a shed session. Always a
    tagged partial — a degraded session never receives a final."""
    sid: str
    index: int
    modality: str
    model: Optional[str]
    t_arrival: float
    t_emit: float
    outputs: Optional[dict]
    kind: str = "partial"
    degraded: bool = True


class GlassShedPath:
    """On-glass provisional serving for shed sessions.

    Reuses the ``stream+tiered`` degradation shape: each shed session's
    own glasses encode the arriving modality (one row, B=1) and re-fuse
    the cached subset tail, timed on a per-session glass clock from the
    ``ProfileTable`` glass tier (no fleet queueing — glasses don't share
    a backlog), so ``t_emit`` is the same on every device. Real numerics
    run on ``device`` (the partials match ``partial_forward``), but
    every emission is ``kind="partial"`` and ``degraded=True``."""

    def __init__(self, models, params, profile, *, bucketer=None,
                 metrics: Optional[Metrics] = None, tracer=None,
                 device="cuda"):
        self.models = models
        self.params = params
        self.profile = profile
        self.bucketer = bucketer
        self.device = _device.resolve(device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer
        self.clock: Dict[str, float] = {}
        self.inputs: Dict[str, dict] = defaultdict(dict)
        self.feats: Dict[str, dict] = defaultdict(dict)
        self.records: List[DegradedRecord] = []
        self.ttfp: Dict[str, float] = {}
        self._first_arrival: Dict[str, float] = {}

    def _encoder_for(self, modality: str):
        for name, sm in self.models.items():
            if modality in sm.modalities():
                return name, sm
        raise KeyError(f"no model consumes modality {modality!r}")

    def serve(self, sid: str, event, payload, t_arrival: float
              ) -> DegradedRecord:
        m = event.modality
        self._first_arrival.setdefault(sid, t_arrival)
        self.inputs[sid][m] = payload
        enc_name, enc_sm = self._encoder_for(m)
        x = torch.as_tensor(payload, device=self.device)
        if self.bucketer:
            x = self.bucketer.fit(m, x)
        with torch.inference_mode():
            self.feats[sid][m] = enc_sm.encoders[m](self.params[enc_name], x)
        total = self.profile.time(f"enc:{m}", "glass")

        name = select_model(self.models, self.inputs[sid])
        outputs = None
        if name is not None:
            sm = self.models[name]
            feats = {mm: self.feats[sid][mm] for mm in sm.modalities()}
            with torch.inference_mode():
                outputs = sm.tail(self.params[name], feats)
            total += self.profile.time("tail", "glass")

        start = max(t_arrival, self.clock.get(sid, 0.0))
        t_emit = start + total
        self.clock[sid] = t_emit
        rec = DegradedRecord(sid=sid, index=event.index, modality=m,
                             model=name, t_arrival=t_arrival,
                             t_emit=t_emit, outputs=outputs)
        self.records.append(rec)
        self.metrics.inc("fleet.degraded_events")
        if outputs is not None:
            self.metrics.inc("fleet.degraded_partials")
            if sid not in self.ttfp:
                self.ttfp[sid] = t_emit - self._first_arrival[sid]
                self.metrics.observe("fleet.ttfp_degraded_s",
                                     self.ttfp[sid])
        if self.tracer:
            self.tracer.instant("fleet.degraded", "fleet", t_emit,
                                track="fleet", sid=sid, index=event.index,
                                modality=m, model=name, kind="partial")
        return rec


# ------------------------------------------------------------ region sim

class RegionSim:
    """N ``EMSServeEngine`` replicas from ONE spec under open-loop load.

    Arrivals (from ``workload.generate_workload``) are replayed in
    global fleet-time order. New sessions route through the
    consistent-hash + least-loaded router and the admission controller;
    admitted events join their replica's pending buffer and are served
    by deadline-free coalescing flushes on the replica's simulated
    serving clock (flush start = ``max(clock, oldest pending arrival)``,
    flush cost = measured wall seconds of the real calls). Shed sessions
    go to the ``GlassShedPath``. Nothing is ever dropped:
    ``sessions_offered == admitted + shed`` is an invariant.

    Every replica and the glass path run on ``device``; with ``mesh``
    (from ``fleet_mesh``), replica ``r`` runs on the mesh's device
    ``r % n`` over a copy of ``params`` made once per device, and the
    glass path on the first."""

    def __init__(self, models, params, *, n_replicas: int = 2,
                 spec: str = "batch+stream", admission=None,
                 profile=None, router: Optional[ConsistentHashRouter] = None,
                 tracer=None, svc_prior_s: float = 0.002,
                 engine_kw: Optional[dict] = None, device="cuda",
                 mesh: Optional[FleetMesh] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas
        self.admission = admission if admission is not None else AdmitAll()
        self.router = (router if router is not None
                       else ConsistentHashRouter(n_replicas))
        if self.router.n_replicas != n_replicas:
            raise ValueError("router sized for "
                             f"{self.router.n_replicas} replicas, "
                             f"sim has {n_replicas}")
        self.metrics = Metrics()
        self.tracer = tracer
        kw = dict(share_encoders=True, deadline_s=None)
        kw.update(engine_kw or {})
        devs = ([_device.resolve(device)] if mesh is None
                else [_device.resolve(d) for d in mesh.devices.reshape(-1)])
        copies = {devs[0]: params}
        for d in devs[1:]:
            copies.setdefault(d, _copy_shared(params, d))
        self.replicas = [build_engine(models, copies[devs[r % len(devs)]],
                                      spec, tracer=tracer,
                                      device=devs[r % len(devs)], **kw)
                         for r in range(n_replicas)]
        self.glass = (GlassShedPath(models, params, profile,
                                    bucketer=kw.get("bucketer"),
                                    metrics=self.metrics, tracer=tracer,
                                    device=devs[0])
                      if profile is not None else None)
        self.clock = [0.0] * n_replicas      # per-replica serving clock
        self.buf: List[List[Tuple[float, str, object]]] = \
            [[] for _ in range(n_replicas)]
        self.route_of: Dict[str, int] = {}   # admitted sid -> replica
        self.degraded: set = set()           # shed sids
        self.ttfp: Dict[str, float] = {}     # admitted sessions
        self.ttfinal: Dict[str, float] = {}
        self.first_arrival: Dict[str, float] = {}
        self.flush_log: List[Tuple[int, float, float, int]] = []
        self._svc_est = float(svc_prior_s)   # EWMA per-event service
        self._payload_fn = None
        self.metrics.set_gauge("fleet.replicas", n_replicas)

    # ---- load estimation -------------------------------------------

    def backlog_s(self, r: int, now: float) -> float:
        """Predicted wait a new arrival to replica ``r`` faces at fleet
        time ``now``: how far the serving clock runs ahead of the data,
        plus the estimated service of everything already buffered."""
        return (max(0.0, self.clock[r] - now)
                + len(self.buf[r]) * self._svc_est)

    # ---- intake -----------------------------------------------------

    def _on_new_session(self, sid: str, now: float) -> None:
        self.metrics.inc("fleet.sessions_offered")
        loads = [self.backlog_s(r, now) for r in range(self.n_replicas)]
        r = self.router.route(sid, loads)
        predicted = loads[r] + self._svc_est
        self.metrics.observe("fleet.predicted_wait_s", predicted)
        if self.admission.admit(r, now, predicted,
                                queue_depth=len(self.buf[r])):
            self.route_of[sid] = r
            self.metrics.inc("fleet.sessions_admitted")
            if self.tracer:
                self.tracer.instant("fleet.admit", "fleet", now,
                                    track="fleet", sid=sid, replica=r,
                                    predicted_wait_s=predicted)
        else:
            if self.glass is None:
                raise RuntimeError(
                    "admission controller shed a session but no "
                    "GlassShedPath is configured (pass profile=...)")
            self.degraded.add(sid)
            self.metrics.inc("fleet.sessions_shed")
            if self.tracer:
                self.tracer.instant("fleet.shed", "fleet", now,
                                    track="fleet", sid=sid, replica=r,
                                    predicted_wait_s=predicted)

    # ---- replica pump ----------------------------------------------

    def _pump(self, r: int, until: float) -> None:
        """Run every flush on replica ``r`` that would start no later
        than fleet time ``until`` (retrospective event-driven sim: a
        flush takes everything that arrived by its start instant)."""
        buf = self.buf[r]
        eng = self.replicas[r]
        while buf:
            start = max(self.clock[r], buf[0][0])
            if start > until:
                break
            i = 0
            while i < len(buf) and buf[i][0] <= start:
                i += 1
            batch, del_n = buf[:i], i
            del buf[:del_n]
            for _, sid, ev in batch:
                eng.submit(sid, ev, self._payload_fn(sid, ev))
            rep = eng.flush()
            done = start + rep.wall_s
            self.clock[r] = done
            self.flush_log.append((r, start, done, rep.n_events))
            if rep.n_events:
                per_ev = rep.wall_s / rep.n_events
                self._svc_est = 0.8 * self._svc_est + 0.2 * per_ev
            self.metrics.inc("fleet.flushes")
            self.metrics.observe("fleet.flush_wall_s", rep.wall_s)
            for p in rep.predictions:
                t0 = self.first_arrival[p.sid]
                if p.sid not in self.ttfp:
                    self.ttfp[p.sid] = done - t0
                    self.metrics.observe("fleet.ttfp_s", self.ttfp[p.sid])
                if p.kind == "final" and p.sid not in self.ttfinal:
                    self.ttfinal[p.sid] = done - t0
                    self.metrics.observe("fleet.ttfinal_s",
                                         self.ttfinal[p.sid])

    # ---- drive ------------------------------------------------------

    def run(self, sessions: Sequence[IncidentSession], payload_fn):
        """Replay the workload; ``payload_fn(sid, event) -> payload``.
        Returns the report dict (also available as ``.report()``)."""
        self._payload_fn = payload_fn
        arrivals = merge_sessions(sessions)
        self._last_arrival = arrivals[-1][0] if arrivals else 0.0
        for t, sid, ev in arrivals:
            if sid not in self.route_of and sid not in self.degraded:
                self.first_arrival[sid] = t
                self._on_new_session(sid, t)
            if sid in self.degraded:
                self.glass.serve(sid, ev, self._payload_fn(sid, ev), t)
                continue
            r = self.route_of[sid]
            # buffer BEFORE pumping: an idle replica flushes the event
            # at its own arrival instant (continuous batching — waiting
            # for the next arrival would put a ~1/rate floor under every
            # light-load TTFP); a busy one leaves it to coalesce with
            # whatever else lands before the clock frees up
            self.buf[r].append((t, sid, ev))
            self.metrics.inc("fleet.events_admitted")
            self._pump(r, t)
        for r in range(self.n_replicas):
            self._pump(r, math.inf)
        return self.report()

    # ---- results ----------------------------------------------------

    def final_outputs(self, sid: str) -> Optional[dict]:
        """Last FINAL prediction outputs of an admitted session (None
        when the session never finalized or was shed)."""
        r = self.route_of.get(sid)
        if r is None:
            return None
        st = self.replicas[r].sessions.get(sid)
        if st is None:
            return None
        for p in reversed(st.predictions):
            if p.kind == "final":
                return p.outputs
        return None

    def makespan(self) -> float:
        glass_last = max((r.t_emit for r in self.glass.records),
                         default=0.0) if self.glass is not None else 0.0
        return max([getattr(self, "_last_arrival", 0.0), glass_last]
                   + list(self.clock))

    def fleet_metrics(self) -> Metrics:
        """Exact fleet-wide registry: the sim's own counters merged with
        every replica engine's (counters summed, quantile sketches
        merged bucket-exactly)."""
        regs = [self.metrics] + [e.metrics for e in self.replicas]
        return Metrics.merged(regs)

    def report(self) -> dict:
        offered = len(self.route_of) + len(self.degraded)
        n_deg_partials = (sum(1 for r in self.glass.records
                              if r.outputs is not None)
                          if self.glass is not None else 0)
        return {
            "n_replicas": self.n_replicas,
            "sessions_offered": offered,
            "sessions_admitted": len(self.route_of),
            "sessions_shed": len(self.degraded),
            "sessions_finalized": len(self.ttfinal),
            "events_admitted": int(
                self.metrics.get("fleet.events_admitted")),
            "events_degraded": (len(self.glass.records)
                                if self.glass is not None else 0),
            "degraded_partials": n_deg_partials,
            "router_spills": self.router.spills,
            "admission": self.admission.stats(),
            "makespan_s": self.makespan(),
            "svc_est_s": self._svc_est,
            "per_replica": [
                {"sessions": sum(1 for v in self.route_of.values()
                                 if v == r),
                 "flushes": sum(1 for f in self.flush_log if f[0] == r),
                 "final_clock_s": self.clock[r]}
                for r in range(self.n_replicas)],
        }


def _copy_shared(params: Dict[str, dict], dev) -> Dict[str, dict]:
    """``params`` on ``dev``, each distinct dict copied once so names
    that share a dict go on sharing it (a tensor already on ``dev`` is
    kept as it is)."""
    by_id: Dict[int, dict] = {}
    for p in params.values():
        if id(p) not in by_id:
            by_id[id(p)] = tree_map(lambda t: t.to(dev), p)
    return {k: by_id[id(v)] for k, v in params.items()}
