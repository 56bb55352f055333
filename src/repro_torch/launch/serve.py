"""EMSServe serving launcher.

The default mode runs a Table-6 episode through the per-event engine
``core.engine.EMSServe`` with adaptive offloading, feature caching and,
optionally, an edge crash, printing the per-event trace.

``--engine tiered`` serves ``--sessions N`` concurrent sessions through
the tiered ``serving.api.EMSServeEngine`` over the 7-model subset zoo
(one shared parameter dict): per-arrival placement on simulated
glass/phone/edge clocks (``--tiers``), the joint (tier, precision)
decision with int8 flights through the hand-written quantized kernels
(``--precision HOST=int8,...``), and an edge outage with heartbeat
failover (``--outage-at``, ``--rejoin-at``). Runs on the CUDA card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --episode 2 --mobility --crash-edge-at 12
  PYTHONPATH=src python -m repro_torch.launch.serve --engine tiered \\
      --tiers glass,ph1,edge64x --precision ph1=int8,edge64x=int8 \\
      --sessions 4 --scenario mix --outage-at 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --text-encoder microbert

The batch/stream specs, speculation, re-dispatch, chaos schedules, the
wall-clock event loop and the fleet simulator exit with the ROADMAP item
that will bring them.
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
        split = (f" tail={r.tail_tier}" if r.tail_tier is not None
                 and r.tail_tier != r.enc_tier else "")
        qz = f" [{r.precision}]" if r.precision != "fp32" else ""
        print(f"[{r.sid:4s} {r.index:2d}] {r.modality:6s} "
              f"tier={r.tier:7s}{qz} {r.kind:7s} "
              f"up={r.uplink_s*1e3:6.1f}ms "
              f"compute={r.compute_s*1e3:7.1f}ms "
              f"down={r.downlink_s*1e3:6.1f}ms "
              f"latency={r.latency_s*1e3:8.1f}ms{fb}{split}")
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


def _later(flag: str, item: str):
    raise SystemExit(f"{flag} belongs to ROADMAP queue 1 {item}, which the "
                     "port does not have yet")


def _check_flags(args):
    """Flags of later slices exit naming their ROADMAP item; flag/spec
    mismatches fail loudly, as in the reference launcher."""
    if args.fleet:
        _later("--fleet", "item 9 (fleet)")
    for flag, on in (("--speculate", args.speculate),
                     ("--redispatch", args.redispatch),
                     ("--chaos-seed", args.chaos_seed >= 0)):
        if on:
            _later(flag, "item 7 (speculation, re-dispatch, chaos)")
    if args.wall_clock:
        _later("--wall-clock", "item 4 (the wall-clock event loop)")
    spec = ()
    if args.engine:
        from ..serving.api import spec_tokens
        try:
            spec = spec_tokens(args.engine)
        except ValueError as e:
            raise SystemExit(f"--engine: {e}") from None
        if not spec:
            raise SystemExit("--engine: empty spec")
    if set(spec) - {"tiered"}:
        _later(f"--engine {args.engine}", "item 4 (the batch+stream flush "
               "path)")
    tiered = "tiered" in spec
    if args.outage_at >= 0 and not tiered:
        raise SystemExit("--outage-at requires a tiered spec "
                         "(e.g. --engine tiered)")
    if args.rejoin_at >= 0 and args.outage_at < 0:
        raise SystemExit("--rejoin-at requires --outage-at")
    if args.tiers and not tiered:
        raise SystemExit("--tiers requires a tiered spec")
    if args.precision and not tiered:
        raise SystemExit("--precision requires a tiered spec")
    return tiered


def serve_tiered(args, dev):
    """``--engine tiered``: build the zoo, profile it on ``dev``, assemble
    the engine, drive the sessions, print the trace."""
    from ..configs.emsnet import config as emsnet_config
    from ..core import (TIER_FACTORS, BandwidthTrace, ProfileTable, horizon,
                        nlos_bandwidth, profile)
    from ..serving.api import build_engine

    n = args.sessions
    eps = scenario_episodes(n, args.scenario)
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

    cfg = emsnet_config(text_encoder=args.text_encoder, vocab_size=2048)
    splits, params = build_zoo(cfg, device=dev)
    payloads = sample_payloads(cfg)
    full = "text+vitals+scene"
    base = profile(splits[full], params[full], payloads, iters=3, device=dev)
    eng = build_engine(splits, params, "tiered", max_history=None,
                       share_encoders=True, device=dev,
                       profile=ProfileTable(base=base),
                       trace=_mobility_trace(args.mobility), **kw)
    if args.outage_at >= 0:
        eng.inject_crash(args.outage_at, rejoin_at=(
            args.rejoin_at if args.rejoin_at >= 0 else None))
        print(f"fault schedule: crash {eng._primary} "
              f"@{args.outage_at:.2f}s, detect @{eng.detect_at:.2f}s"
              + (f", rejoin @{args.rejoin_at:.2f}s"
                 if args.rejoin_at >= 0 else " (no restart)"))
    eng.run_arrivals(eps, lambda sid, ev: payloads[ev.modality])
    _print_tiered(eng, n)
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
                    help="multi-session engine spec; this port serves "
                         "'tiered'")
    ap.add_argument("--sessions", type=int, default=4, metavar="N",
                    help="--engine: number of concurrent sessions")
    ap.add_argument("--scenario", default="mix",
                    choices=["mix", "text_first", "vitals_first",
                             "scene_late"],
                    help="--engine: inter-modality lag scenario")
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
    ap.add_argument("--wall-clock", action="store_true")
    ap.add_argument("--fleet", type=float, default=0.0, metavar="RATE")
    args = ap.parse_args(argv)

    tiered = _check_flags(args)
    dev = _device.resolve(args.device)
    if tiered:
        serve_tiered(args, dev)
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
