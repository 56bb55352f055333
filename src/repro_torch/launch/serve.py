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
    failover (``--outage-at``, ``--rejoin-at``); ``stream+tiered`` also
    serves on-glass provisional partials while a remote tier computes.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --text-encoder microbert

Speculation, re-dispatch, chaos schedules, tracing and metrics export,
the legacy ``--batched``/``--stream`` flags and the fleet simulator exit
with the ROADMAP item that will bring them.
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


def _later(flag: str, item: str):
    raise SystemExit(f"{flag} belongs to ROADMAP queue 1 {item}, which the "
                     "port does not have yet")


def _check_flags(args):
    """Flags of later slices exit naming their ROADMAP item; flag/spec
    mismatches fail loudly, as in the reference launcher. Returns the
    spec's canonical tokens (empty for the per-event default)."""
    if args.fleet:
        _later("--fleet", "item 9 (fleet)")
    for flag, on in (("--speculate", args.speculate),
                     ("--redispatch", args.redispatch),
                     ("--chaos-seed", args.chaos_seed >= 0)):
        if on:
            _later(flag, "item 7 (speculation, re-dispatch, chaos)")
    for flag, on in (("--trace", args.trace),
                     ("--metrics-out", args.metrics_out)):
        if on:
            _later(flag, "item 8 (observability)")
    for flag, on in (("--batched", args.batched), ("--stream", args.stream)):
        if on:
            _later(flag, "item 10 (the legacy mode flags)")
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
    if args.deadline_ms and not stream:
        raise SystemExit("--deadline-ms requires a stream spec")
    if args.wall_clock and not (stream or tiered):
        raise SystemExit("--wall-clock requires a stream or tiered spec")
    if args.precision and not tiered:
        raise SystemExit("--precision requires a tiered spec")
    if args.ragged and (tiered or not spec):
        raise SystemExit("--ragged requires a flush-mode spec (batch "
                         "and/or stream); tiered places each arrival "
                         "individually and never coalesces a flush")
    return spec


def _tiered_options(args, eps):
    """PlacementPolicy overrides of a tiered spec: the precision map and
    the tier list (the phone on a near-field tether), checked against
    the episodes' horizon for the outage flags."""
    from ..core import TIER_FACTORS, BandwidthTrace, horizon, nlos_bandwidth
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
    kw = {}
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
    return kw


def serve_unified(args, spec, dev):
    """One path for every ``--engine`` spec: build the models, assemble
    the engine from its policies, drive the sessions, print the trace."""
    from ..configs.emsnet import config as emsnet_config
    from ..core import Bucketer, ProfileTable, profile, table6
    from ..serving.api import build_engine

    n = args.sessions
    tiered, stream = "tiered" in spec, "stream" in spec
    eps = scenario_episodes(n, args.scenario) if tiered or stream else None
    kw = _tiered_options(args, eps) if tiered else {}
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
                       device=dev, **kw)

    if tiered and args.outage_at >= 0:
        eng.inject_crash(args.outage_at, rejoin_at=(
            args.rejoin_at if args.rejoin_at >= 0 else None))
        print(f"fault schedule: crash {eng._primary} "
              f"@{args.outage_at:.2f}s, detect @{eng.detect_at:.2f}s"
              + (f", rejoin @{args.rejoin_at:.2f}s"
                 if args.rejoin_at >= 0 else " (no restart)"))
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
    elif stream:
        _print_stream(eng, eps)
    else:
        _print_batch(eng, n)
    if args.ragged:
        pf = [f.padded_flop_frac for f in eng.flushes]
        print(f"ragged flush: {eng.ragged.n_shapes()} packed shapes, "
              f"mean padded-FLOP fraction "
              f"{float(np.mean(pf)) if pf else 0.0:.3f} on {eng.device}")
    return eng


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
                         "window before flushing (0 = flush per arrival)")
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
    # ---- flags of later slices: each exits naming its ROADMAP item
    ap.add_argument("--speculate", action="store_true")
    ap.add_argument("--redispatch", action="store_true")
    ap.add_argument("--chaos-seed", type=int, default=-1, metavar="SEED")
    ap.add_argument("--trace", default="", metavar="PATH")
    ap.add_argument("--metrics-out", default="", metavar="PATH")
    ap.add_argument("--batched", type=int, default=0, metavar="N")
    ap.add_argument("--stream", type=int, default=0, metavar="N")
    ap.add_argument("--fleet", type=float, default=0.0, metavar="RATE")
    args = ap.parse_args(argv)

    spec = _check_flags(args)
    dev = _device.resolve(args.device)
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
