"""EMSServe serving launcher.

The default mode runs a Table-6 episode through the per-event engine
``core.engine.EMSServe`` with adaptive offloading, feature caching and,
optionally, an edge crash, printing the per-event trace.

``--engine SPEC`` serves ``--sessions N`` concurrent sessions through
the unified ``serving.api.EMSServeEngine``, where SPEC is a '+'-joined
subset of ``batch`` / ``stream`` / ``tiered``:

  * ``batch`` coalesces the sessions' Table-6 episodes into
    shape-bucketed batched calls (``--ragged``: one packed call per
    modality and one grouped fusion tail per flush);
  * ``stream`` adds progressive partial->final predictions over the
    ``--scenario`` episodes, flushing every ``--deadline-ms`` of episode
    time, or of wall time with ``--wall-clock`` (``--speed`` episode
    seconds per wall second);
  * ``tiered`` places each arrival on simulated glass/phone/edge clocks
    (``--tiers``), with the joint (tier, precision) decision and int8
    flights through the hand-written quantized kernels
    (``--precision HOST=int8,...``) and an edge outage with heartbeat
    failover (``--outage-at``, ``--rejoin-at``) or a seeded crash/rejoin
    schedule over the remote tiers (``--chaos-seed``); ``--speculate``
    races deadline-pressured arrivals on glass and the best remote
    (``--spec-deadline-ms``, ``--spec-margin-ms``), and ``--redispatch``
    re-aims a flight lost to a crash at a surviving remote;
    ``stream+tiered`` also serves on-glass provisional partials while a
    remote tier computes.

``--fleet RATE`` runs the region simulator (``fleet.RegionSim``):
``--replicas N`` engine replicas built from one spec over parameters
placed on the visible devices, whole incident sessions offered open
loop at RATE sessions/s (``--sessions`` of them), consistent-hash +
least-loaded routing, and deadline admission (``--deadline-ms``, 500 by
default) shedding new sessions to the on-glass degraded path.

``--trace PATH`` records every arrival's lifecycle and exports a Chrome
trace-event JSON (Perfetto-loadable; ``python -m repro_torch.obs.audit
PATH`` re-verifies the serving invariants from it); in fleet mode a
``.jsonl`` PATH streams through the bounded-memory ``StreamingTracer``.
``--metrics-out PATH`` writes the metrics registry as Prometheus text
(fleet mode: the exact merge across replicas).

The deprecated ``--batched N``/``--stream N``/``--tiered N`` flags map
onto ``--engine batch|stream|tiered --sessions N`` with a note.

Each model piece runs as a CUDA graph captured per input signature on
the card (``core.splitter.split``; the CPU counts the same signatures);
the batch and stream summaries print that count as ``CUDA graphs N``.

Runs on the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --episode 2 --mobility --crash-edge-at 12
  PYTHONPATH=src python -m repro_torch.launch.serve --engine batch --sessions 8
  PYTHONPATH=src python -m repro_torch.launch.serve --engine batch+stream \\
      --sessions 8 --ragged
  PYTHONPATH=src python -m repro_torch.launch.serve --engine stream \\
      --sessions 4 --wall-clock --deadline-ms 50 --speed 10
  PYTHONPATH=src python -m repro_torch.launch.serve --engine tiered \\
      --tiers glass,ph1,edge64x --precision ph1=int8,edge64x=int8 \\
      --sessions 4 --scenario mix --outage-at 4
  PYTHONPATH=src python -m repro_torch.launch.serve --engine tiered \\
      --tiers glass,ph1,edge64x --precision ph1=int8,edge64x=int8 \\
      --speculate --redispatch --chaos-seed 5 --trace trace.json \\
      --metrics-out metrics.prom
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 4 --replicas 2 \\
      --sessions 12 --trace fleet.jsonl --metrics-out fleet.prom
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --text-encoder microbert
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import device as _device


def build_models(cfg, *, seed=0, device="cuda"):
    """m1 (text), m2 (text+vitals), m3 (text+vitals+scene), each with its
    own random weights from a seeded ``torch.Generator``; the weights are
    drawn on the CPU, so one seed gives the same weights on every
    device."""
    from ..core import emsnet_module, split
    dev = _device.resolve(device)
    mods = {
        "m1": emsnet_module(cfg, ("text",)),
        "m2": emsnet_module(cfg, ("text", "vitals")),
        "m3": emsnet_module(cfg, ("text", "vitals", "scene")),
    }
    splits = {k: split(m) for k, m in mods.items()}
    params = {k: m.init_fn(torch.Generator().manual_seed(seed * 1000 + i),
                           device=dev)
              for i, (k, m) in enumerate(mods.items())}
    return splits, params


def build_zoo(cfg, *, seed=0, device="cuda"):
    """The 7-model subset zoo over ONE shared parameter dict (drawn on the
    CPU from a seeded ``torch.Generator``, then moved to ``device``)."""
    from ..core import emsnet_zoo, split
    dev = _device.resolve(device)
    zoo = emsnet_zoo(cfg)
    splits = {k: split(m) for k, m in zoo.items()}
    shared = zoo["text+vitals+scene"].init_fn(
        torch.Generator().manual_seed(seed), device=dev)
    return splits, {k: shared for k in zoo}


def sample_payloads(cfg, seed=0):
    """One payload per modality, drawn with numpy as the reference
    launcher draws them (numpy arrays; the engines move them)."""
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, cfg.max_text_len)).astype(np.int32),
        "vitals": rng.normal(size=(1, cfg.vitals_len,
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }


def scenario_episodes(n_sessions, scenario, *, n_vitals=4, n_scene=2):
    from ..core import async_episode
    names = (["text_first", "vitals_first", "scene_late"]
             if scenario == "mix" else [scenario])
    return {f"s{i}": async_episode(names[i % len(names)], seed=i,
                                   n_vitals=n_vitals, n_scene=n_scene)
            for i in range(n_sessions)}


def _mobility_trace(mobility: bool):
    from ..core import BandwidthTrace, nlos_bandwidth
    if mobility:
        dist = list(np.linspace(0, 30, 11)) + list(np.linspace(30, 0, 11))
        return BandwidthTrace.walk(dist, nlos_bandwidth, period=1.0)
    return BandwidthTrace.static(nlos_bandwidth(5.0))


def _print_tiered(eng, n_sessions):
    for r in eng.records:
        fb = " !! failover" if r.fallback else ""
        gp = (f" (glass partial @{r.glass_partial.t_emit:6.2f}s)"
              if r.glass_partial is not None else "")
        split = (f" tail={r.tail_tier}" if r.tail_tier is not None
                 and r.tail_tier != r.enc_tier else "")
        qz = f" [{r.precision}]" if r.precision != "fp32" else ""
        print(f"[{r.sid:4s} {r.index:2d}] {r.modality:6s} "
              f"tier={r.tier:7s}{qz} {r.kind:7s} "
              f"up={r.uplink_s*1e3:6.1f}ms "
              f"compute={r.compute_s*1e3:7.1f}ms "
              f"down={r.downlink_s*1e3:6.1f}ms "
              f"latency={r.latency_s*1e3:8.1f}ms{fb}{split}{gp}")
    pc = eng.placement_counts()
    fallbacks = pc.pop("fallbacks")
    placed = " / ".join(f"{n} {tier}" for tier, n in pc.items())
    print(f"\n{n_sessions} sessions, {eng.events_total} arrivals: "
          f"{placed} / {fallbacks} crash failovers / "
          f"{eng.rejoin_count} rejoins")
    for link, s in eng.transport_stats()["links"].items():
        print(f"  link {link:18s} {s['bytes']/1e6:8.2f} MB in "
              f"{s['msgs']:3d} msgs")
    print(f"cumulative serving latency {eng.total_latency_s()*1e3:.1f} ms "
          f"on {eng.device}")


def _print_speculation(eng):
    ss = eng.speculation_stats()
    wins = " / ".join(f"{v} {t}" for t, v in ss["wins"].items() if v)
    print(f"speculation: {ss['races']} races ({wins or 'no wins'}), "
          f"{ss['crash_saves']} crash saves, "
          f"{ss['redispatches']} re-dispatches, "
          f"{ss['cancelled_msgs']} cancelled transfers, "
          f"{ss['duplicate_commits']} duplicate commits")


def _shapes(eng) -> int:
    """Distinct encoder input shapes served: bucketed (modality, length)
    pairs, or packed (modality, (rows, length)) buffers."""
    return (eng.ragged.n_shapes() if eng.ragged is not None
            else eng.bucketer.n_buckets())


def _print_stream(eng, eps):
    for f in eng.flushes:
        for p in f.predictions:
            proto = int(torch.argmax(p.outputs["protocol_logits"]))
            print(f"flush[{f.flush_id:3d}] {p.sid:4s} "
                  f"{p.kind:7s} over {'+'.join(p.modalities):24s} "
                  f"-> protocol={proto}")
    for sid in sorted(eng.sessions):
        ttfp = eng.time_to_first_prediction(sid)
        ttf = eng.time_to_final_prediction(sid)
        print(f"  {sid}: time-to-first "
              f"{'n/a' if ttfp is None else f'{ttfp*1e3:7.1f} ms'} | "
              f"time-to-final "
              f"{'n/a' if ttf is None else f'{ttf*1e3:7.1f} ms'}")
    print(f"\n{len(eps)} sessions, {eng.events_total} arrivals, "
          f"{eng.flushes_total} flushes, "
          f"{eng.encoder_calls_total()} encoder calls, "
          f"{_shapes(eng)} input shapes, "
          f"CUDA graphs {eng.compile_count()} on {eng.device}")


def _print_batch(eng, n_sessions):
    for f in eng.flushes:
        print(f"flush[{f.flush_id:2d}] events={f.n_events:3d} "
              f"enc_calls={f.n_encoder_calls} tail_calls={f.n_tail_calls} "
              f"wall={f.wall_s*1e3:7.2f}ms")
    lats = sorted(eng.event_latencies())
    print(f"\n{n_sessions} sessions, {eng.events_total} events in "
          f"{eng.total_wall_s()*1e3:.1f} ms compute "
          f"(p50 latency {lats[len(lats)//2]*1e3:.1f} ms, "
          f"{_shapes(eng)} input shapes, "
          f"CUDA graphs {eng.compile_count()}, "
          f"cache entries {len(eng.cache)}) on {eng.device}")


def _apply_legacy_shims(args):
    """Map the pre-unification mode flags onto --engine specs, with a
    one-line pointer to the replacement."""
    for flag, count, spec in (("--batched", args.batched, "batch"),
                              ("--stream", args.stream, "stream"),
                              ("--tiered", args.tiered, "tiered")):
        if count:
            if args.engine:
                raise SystemExit(f"{flag} conflicts with --engine; "
                                 f"use --engine alone")
            args.engine = spec
            args.sessions = count
            print(f"note: {flag} N is deprecated — use "
                  f"`--engine {spec} --sessions {count}` "
                  f"(specs compose, e.g. --engine stream+tiered)")
    return args


def _check_flags(args):
    """Flag/spec mismatches fail loudly, as in the reference launcher.
    Returns the spec's canonical tokens (empty for the per-event default
    and the fleet)."""
    if args.fleet < 0.0:
        raise SystemExit("--fleet RATE must be > 0 (sessions/s)")
    if args.fleet and args.engine:
        raise SystemExit("--fleet conflicts with --engine: the region "
                         "simulator builds its own replica engines "
                         "from one spec")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    for flag, on in (("--trace", args.trace),
                     ("--metrics-out", args.metrics_out)):
        if on and not (args.engine or args.fleet):
            raise SystemExit(f"{flag} requires --engine or --fleet (the "
                             "per-event engine predates the traced "
                             "serving stack)")
    spec = ()
    if args.engine:
        from ..serving.api import spec_tokens
        try:
            spec = spec_tokens(args.engine)
        except ValueError as e:
            raise SystemExit(f"--engine: {e}") from None
        if not spec:
            raise SystemExit("--engine: empty spec")
    tiered, stream = "tiered" in spec, "stream" in spec
    if args.outage_at >= 0 and not tiered:
        raise SystemExit("--outage-at requires a tiered spec "
                         "(e.g. --engine tiered)")
    if args.rejoin_at >= 0 and args.outage_at < 0:
        raise SystemExit("--rejoin-at requires --outage-at")
    if args.tiers and not tiered:
        raise SystemExit("--tiers requires a tiered spec")
    if args.deadline_ms and not (stream or args.fleet):
        raise SystemExit("--deadline-ms requires a stream spec or --fleet")
    if args.wall_clock and not (stream or tiered):
        raise SystemExit("--wall-clock requires a stream or tiered spec")
    if (args.speculate or args.redispatch) and not tiered:
        raise SystemExit("--speculate/--redispatch require a tiered spec")
    if args.precision and not tiered:
        raise SystemExit("--precision requires a tiered spec")
    if args.chaos_seed >= 0 and not tiered:
        raise SystemExit("--chaos-seed requires a tiered spec")
    if args.chaos_seed >= 0 and args.outage_at >= 0:
        raise SystemExit("--chaos-seed conflicts with --outage-at; pick "
                         "one fault schedule")
    if args.ragged and (tiered or not spec):
        raise SystemExit("--ragged requires a flush-mode spec (batch "
                         "and/or stream); tiered places each arrival "
                         "individually and never coalesces a flush")
    return spec


def _tiered_options(args, eps):
    """PlacementPolicy overrides of a tiered spec: the precision map, the
    tier list (the phone on a near-field tether), speculation and
    re-dispatch, checked against the episodes' horizon for the outage
    flags; and the chaos schedule over the remote tiers (or None)."""
    from ..core import (TIER_FACTORS, BandwidthTrace, SpeculationPolicy,
                        horizon, nlos_bandwidth)
    span = horizon(eps)
    if args.outage_at >= 0:
        if args.outage_at > span:
            raise SystemExit(
                f"--outage-at {args.outage_at:g} is beyond the episode "
                f"horizon ({span:.2f}s): the crash would never be observed")
        if args.rejoin_at >= 0 and args.rejoin_at <= args.outage_at:
            raise SystemExit(
                f"--rejoin-at {args.rejoin_at:g} must be strictly after "
                f"--outage-at {args.outage_at:g}")
    chaos = None
    if args.chaos_seed >= 0:
        if not args.tiers:
            raise SystemExit("--chaos-seed needs --tiers (the schedule "
                             "spans the remote tiers)")
        from ..serving.chaos import chaos_schedule
        remote = tuple(t.strip() for t in args.tiers.split(",")
                       if t.strip())[1:]
        chaos = chaos_schedule(args.chaos_seed, horizon=span, tiers=remote)
    kw = {}
    if args.speculate:
        kw["speculation"] = SpeculationPolicy(
            deadline_s=args.spec_deadline_ms / 1e3,
            margin_s=args.spec_margin_ms / 1e3)
    if args.redispatch:
        kw["redispatch"] = True
    if args.precision:
        prec = {}
        for part in filter(None, (p.strip()
                                  for p in args.precision.split(","))):
            host, sep, p = part.partition("=")
            if not sep or not host.strip() or not p.strip():
                raise SystemExit(
                    f"--precision: malformed entry {part!r} "
                    "(expected HOST=fp32|int8, comma-separated)")
            prec[host.strip()] = p.strip()
        kw["precision"] = prec
    if args.tiers:
        tiers = tuple(t.strip() for t in args.tiers.split(",") if t.strip())
        unknown = [t for t in tiers if t not in TIER_FACTORS]
        if unknown or len(tiers) < 2:
            raise SystemExit(
                f"--tiers: unknown tier(s) {unknown} or too few; pick >= 2 "
                f"of {sorted(TIER_FACTORS)} (local first)")
        kw["tiers"] = tiers
        # the EMT's phone rides in a pocket: a near-field tether, unlike
        # the distance-degraded glass<->edge WiFi
        kw["tier_traces"] = {t: BandwidthTrace.static(nlos_bandwidth(0.0))
                             for t in tiers[1:] if t.startswith("ph")}
    kw["trace"] = _mobility_trace(args.mobility)
    return kw, chaos


def serve_unified(args, spec, dev):
    """One path for every ``--engine`` spec: build the models, assemble
    the engine from its policies, drive the sessions, print the trace."""
    from ..configs.emsnet import config as emsnet_config
    from ..core import Bucketer, ProfileTable, profile, table6
    from ..serving.api import build_engine

    n = args.sessions
    tiered, stream = "tiered" in spec, "stream" in spec
    eps = scenario_episodes(n, args.scenario) if tiered or stream else None
    kw, chaos = _tiered_options(args, eps) if tiered else ({}, None)
    tracer = None
    if args.trace:
        from ..obs import Tracer
        tracer = Tracer()
    cfg = emsnet_config(text_encoder=args.text_encoder, vocab_size=2048)
    if tiered or stream:
        splits, params = build_zoo(cfg, device=dev)   # one shared dict
        kw["share_encoders"] = True
    else:
        splits, params = build_models(cfg, device=dev)  # independent m1-m3
    payloads = sample_payloads(cfg)

    def payload_fn(sid, ev):
        return payloads[ev.modality]

    if tiered:
        full = "text+vitals+scene"
        kw["profile"] = ProfileTable(base=profile(
            splits[full], params[full], payloads, iters=3, device=dev))
    if stream:
        kw["deadline_s"] = (args.deadline_ms / 1e3 if args.wall_clock
                            else None)
    if "batch" in spec or stream:
        kw["bucketer"] = Bucketer(max_buckets={"vitals": cfg.vitals_len,
                                               "text": cfg.max_text_len})
        kw["batch_bucket_min"] = min(8, n)
        if args.ragged:
            kw["ragged"] = True
    eng = build_engine(splits, params, "+".join(spec), max_history=None,
                       tracer=tracer, device=dev, **kw)

    if tiered and args.outage_at >= 0:
        eng.inject_crash(args.outage_at, rejoin_at=(
            args.rejoin_at if args.rejoin_at >= 0 else None))
        print(f"fault schedule: crash {eng._primary} "
              f"@{args.outage_at:.2f}s, detect @{eng.detect_at:.2f}s"
              + (f", rejoin @{args.rejoin_at:.2f}s"
                 if args.rejoin_at >= 0 else " (no restart)"))
    if chaos is not None:
        eng.inject_schedule(chaos)
        print(f"fault schedule: chaos seed {args.chaos_seed}, "
              f"{len(chaos)} crash/rejoin cycles")
        for e in chaos:
            rj = (f"rejoin @{e.rejoin_at:6.2f}s" if e.rejoin_at is not None
                  else "no restart")
            print(f"  crash {e.tier:8s} @{e.crash_at:6.2f}s, {rj}")
    if args.wall_clock:
        from ..serving.event_loop import WallClockDriver
        WallClockDriver(eng, speed=args.speed).run(eps, payload_fn)
    elif tiered:
        eng.run_arrivals(eps, payload_fn)
    elif stream:
        eng.run_arrivals(eps, payload_fn, sim_window=args.deadline_ms / 1e3)
    else:
        eps = {f"s{i}": table6()[1 + i % 3] for i in range(n)}
        eng.run_episodes(eps, payload_fn)
    if tiered:
        _print_tiered(eng, n)
        if args.speculate or args.redispatch:
            _print_speculation(eng)
    elif stream:
        _print_stream(eng, eps)
    else:
        _print_batch(eng, n)
    if args.ragged:
        pf = [f.padded_flop_frac for f in eng.flushes]
        print(f"ragged flush: {eng.ragged.n_shapes()} packed shapes, "
              f"mean padded-FLOP fraction "
              f"{float(np.mean(pf)) if pf else 0.0:.3f} on {eng.device}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(eng.metrics.to_prometheus())
        print(f"metrics: prometheus text -> {args.metrics_out}")
    if tracer is not None:
        other = {"metrics": eng.metrics_snapshot()}
        if tiered:
            other["transport"] = eng.fabric.stats()
        n_ev = tracer.export(args.trace, other_data=other)
        print(f"trace: {n_ev} events -> {args.trace} (load in Perfetto; "
              f"audit: python -m repro_torch.obs.audit {args.trace})")
    return eng


def serve_fleet(args, dev):
    """``--fleet RATE``: open-loop region simulation — ``--replicas N``
    engine replicas built from ONE spec over placed parameters, Poisson
    session arrivals at RATE sessions/s, consistent-hash + least-loaded
    routing, deadline admission control, and the on-glass degraded shed
    path for what the region turns away."""
    from ..configs.emsnet import config as emsnet_config
    from ..core import ProfileTable, profile
    from ..fleet import (AdmissionController, AdmissionPolicy, RegionSim,
                         fleet_mesh, generate_workload, place_fleet_params)

    cfg = emsnet_config(text_encoder=args.text_encoder, vocab_size=2048)
    splits, params = build_zoo(cfg, device=dev)
    mesh = fleet_mesh(args.replicas, device=dev)
    placed, placement = place_fleet_params(params, mesh)
    payloads = sample_payloads(cfg)

    def payload_fn(sid, ev):
        return payloads[ev.modality]

    tracer = None
    if args.trace:
        from ..obs import StreamingTracer, Tracer
        tracer = (StreamingTracer(args.trace, buffer=512)
                  if args.trace.endswith(".jsonl") else Tracer())

    full = "text+vitals+scene"
    base = profile(splits[full], placed[full], payloads, iters=2,
                   device=mesh.devices[0, 0])
    deadline = (args.deadline_ms / 1e3) if args.deadline_ms else 0.5
    ctrl = AdmissionController(AdmissionPolicy(deadline_s=deadline),
                               args.replicas)
    sim = RegionSim(splits, placed, n_replicas=args.replicas,
                    admission=ctrl, profile=ProfileTable(base=base),
                    tracer=tracer, mesh=mesh)
    axes = "x".join(str(v) for v in placement["axis_sizes"].values())
    print(f"fleet: {args.replicas} replicas, params on {axes} mesh over "
          f"{placement['devices']} device(s) "
          f"({placement['replicated_leaves']} replicated / "
          f"{placement['sharded_leaves']} sharded leaves, "
          f"{placement['param_bytes'] / 1e6:.1f} MB), "
          f"admission deadline {deadline * 1e3:.0f} ms")

    horizon = args.sessions / args.fleet
    sessions = generate_workload(args.fleet, horizon, seed=0)
    rep = sim.run(sessions, payload_fn)

    ttfp = sorted(sim.ttfp.values())

    def p(q):
        return (ttfp[min(len(ttfp) - 1, int(q * len(ttfp)))] if ttfp
                else float("nan"))
    print(f"\n{rep['sessions_offered']} sessions offered @ "
          f"{args.fleet:g}/s: {rep['sessions_admitted']} admitted "
          f"({rep['sessions_finalized']} finalized), "
          f"{rep['sessions_shed']} shed to glass "
          f"({rep['degraded_partials']} degraded partials)")
    for r, pr in enumerate(rep["per_replica"]):
        print(f"  replica {r}: {pr['sessions']:3d} sessions "
              f"{pr['flushes']:4d} flushes "
              f"idle-at {pr['final_clock_s']:.2f}s")
    print(f"admitted TTFP p50 {p(0.50) * 1e3:7.1f} ms | "
          f"p95 {p(0.95) * 1e3:7.1f} ms | "
          f"makespan {rep['makespan_s']:.2f}s | "
          f"{rep['sessions_finalized'] / rep['makespan_s']:.2f} "
          f"finalized sessions/s on {dev}")

    mx = sim.fleet_metrics()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(mx.to_prometheus())
        print(f"metrics: prometheus text -> {args.metrics_out}")
    if tracer is not None:
        n_ev = tracer.export(args.trace,
                             other_data={"metrics": mx.snapshot()})
        print(f"trace: {n_ev} events -> {args.trace} "
              f"(audit: python -m repro_torch.obs.audit {args.trace})")
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episode", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--text-encoder", default="tinybert")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--mobility", action="store_true",
                    help="walk away from the edge box and back (NLOS trace)")
    ap.add_argument("--crash-edge-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--engine", default="", metavar="SPEC",
                    help="unified session engine: '+'-joined subset of "
                         "batch/stream/tiered (e.g. batch+stream, "
                         "stream+tiered)")
    ap.add_argument("--sessions", type=int, default=4, metavar="N",
                    help="--engine: number of concurrent sessions")
    ap.add_argument("--scenario", default="mix",
                    choices=["mix", "text_first", "vitals_first",
                             "scene_late"],
                    help="stream/tiered specs: inter-modality lag scenario")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="stream spec: coalesce arrivals within this "
                         "window before flushing (0 = flush per arrival); "
                         "--fleet: the admission deadline (default 500)")
    ap.add_argument("--ragged", action="store_true",
                    help="batch/stream specs: pack the pending rows of "
                         "each variable-length modality into ONE ragged "
                         "encoder call per flush and fuse all pending "
                         "tails in ONE grouped call")
    ap.add_argument("--wall-clock", action="store_true",
                    help="stream/tiered specs: replay arrivals and pump "
                         "deadline flushes from a monotonic clock")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="--wall-clock: episode seconds per wall second")
    ap.add_argument("--tiers", default="", metavar="LIST",
                    help="tiered spec: comma-separated ordered tier list "
                         "from core.offload.TIER_FACTORS, local first "
                         "(e.g. glass,ph1,edge64x); enables contention-"
                         "aware decisions and per-submodule tail placement")
    ap.add_argument("--precision", default="", metavar="MAP",
                    help="tiered spec: comma-separated HOST=fp32|int8 map "
                         "(e.g. ph1=int8,edge64x=int8) arming the joint "
                         "precision+placement decision")
    ap.add_argument("--outage-at", type=float, default=-1.0, metavar="S",
                    help="tiered spec: kill the fastest remote tier at "
                         "episode second S (heartbeat-detected failover)")
    ap.add_argument("--rejoin-at", type=float, default=-1.0, metavar="S",
                    help="tiered spec: restart the crashed tier at episode "
                         "second S (replica re-warm, eligible again)")
    ap.add_argument("--speculate", action="store_true",
                    help="tiered spec: arm speculative dual placement — "
                         "deadline-pressured arrivals race glass against "
                         "the best remote (cancel-on-commit)")
    ap.add_argument("--spec-deadline-ms", type=float, default=350.0,
                    help="--speculate: per-arrival serving deadline")
    ap.add_argument("--spec-margin-ms", type=float, default=50.0,
                    help="--speculate: race when the estimated slack "
                         "before the deadline dips below this")
    ap.add_argument("--redispatch", action="store_true",
                    help="tiered spec: re-aim a flight lost to a tier "
                         "crash at the next-best surviving remote instead "
                         "of always re-running it on glass")
    ap.add_argument("--chaos-seed", type=int, default=-1, metavar="SEED",
                    help="tiered spec with --tiers: a seeded crash/rejoin "
                         "schedule over the remote tiers")
    ap.add_argument("--fleet", type=float, default=0.0, metavar="RATE",
                    help="region simulation: offer whole incident "
                         "sessions at RATE sessions/s (open-loop "
                         "Poisson) to --replicas engine replicas with "
                         "admission control; --sessions N is the total "
                         "offered count")
    ap.add_argument("--replicas", type=int, default=2, metavar="N",
                    help="--fleet: engine replicas (replica r runs on "
                         "visible CUDA device r %% n)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="--engine/--fleet: record every arrival's "
                         "lifecycle and export a Chrome trace-event JSON "
                         "(Perfetto-loadable, auditable with python -m "
                         "repro_torch.obs.audit); a .jsonl PATH in fleet "
                         "mode streams through the bounded-memory "
                         "StreamingTracer instead")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="--engine/--fleet: write the run's metrics "
                         "registry as Prometheus text to PATH (fleet "
                         "mode: exact fleet-wide merge across replicas)")
    # ---- deprecated mode flags (shims onto --engine)
    ap.add_argument("--batched", type=int, default=0, metavar="N",
                    help="deprecated: --engine batch --sessions N")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="deprecated: --engine stream --sessions N")
    ap.add_argument("--tiered", type=int, default=0, metavar="N",
                    help="deprecated: --engine tiered --sessions N")
    args = _apply_legacy_shims(ap.parse_args(argv))

    spec = _check_flags(args)
    dev = _device.resolve(args.device)
    if args.fleet:
        serve_fleet(args, dev)
        return
    if spec:
        serve_unified(args, spec, dev)
        return

    from ..configs.emsnet import config as emsnet_config
    from ..core import (AdaptiveOffloadPolicy, EMSServe, HeartbeatMonitor,
                        ProfileTable, profile, table6)

    cfg = emsnet_config(text_encoder=args.text_encoder, vocab_size=2048)
    splits, params = build_models(cfg, device=dev)
    payloads = sample_payloads(cfg)

    base = profile(splits["m3"], params["m3"], payloads, device=dev)
    policy = AdaptiveOffloadPolicy(
        ProfileTable(base=base),
        HeartbeatMonitor(_mobility_trace(args.mobility)))

    engine = EMSServe(splits, params, policy=policy,
                      cached=not args.no_cache, device=dev)
    for i, ev in enumerate(table6()[args.episode]):
        if i == args.crash_edge_at:
            print("!! edge server crash — failing over to on-glass inference")
            engine.crash_edge()
        rec = engine.on_event(ev, payloads[ev.modality])
        top = ""
        if rec.recommendation is not None:
            p = int(torch.argmax(rec.recommendation["protocol_logits"]))
            m = int(torch.argmax(rec.recommendation["medicine_logits"]))
            q = float(rec.recommendation["quantity"][0])
            top = f" -> protocol={p} medicine={m} qty={q:+.2f}"
        print(f"[{ev.index:2d}] {ev.modality:6s} tier={rec.tier:5s} "
              f"dt={rec.delta_t*1e3:7.2f}ms compute={rec.compute_s*1e3:7.2f}ms "
              f"cum={rec.cumulative_s*1e3:8.2f}ms{top}")
    print(f"\ncumulative serving time: {engine.cumulative_time()*1e3:.1f} ms "
          f"(cache hits: {engine.cache.hits}) on {dev}")


if __name__ == "__main__":
    main()
