"""EMSServe serving launcher (per-event engine).

Runs a Table-6 episode through ``core.engine.EMSServe`` with adaptive
offloading, feature caching and, optionally, an edge crash, printing the
per-event trace. Runs on the CUDA card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --episode 2 --mobility --crash-edge-at 12
  PYTHONPATH=src python -m repro_torch.launch.serve --episode 1 --no-cache
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The multi-session ``--engine`` and ``--fleet`` modes of the reference
launcher join with the slices that port their engines.
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


def sample_payloads(cfg, seed=0):
    """One payload per modality, drawn with numpy as the reference
    launcher draws them (numpy arrays; the engine moves them)."""
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, cfg.max_text_len)).astype(np.int32),
        "vitals": rng.normal(size=(1, cfg.vitals_len,
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }


def _mobility_trace(mobility: bool):
    from ..core import BandwidthTrace, nlos_bandwidth
    if mobility:
        dist = list(np.linspace(0, 30, 11)) + list(np.linspace(30, 0, 11))
        return BandwidthTrace.walk(dist, nlos_bandwidth, period=1.0)
    return BandwidthTrace.static(nlos_bandwidth(5.0))


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
    args = ap.parse_args(argv)

    from ..configs.emsnet import config as emsnet_config
    from ..core import (AdaptiveOffloadPolicy, EMSServe, HeartbeatMonitor,
                        ProfileTable, profile, table6)

    dev = _device.resolve(args.device)
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
