"""EMSServe scenario demo on the PyTorch port: adaptive offloading under
mobility + edge crash fault tolerance (paper §4.2.3 + Figure 15).

An EMT wearing the glass walks away from the manpack edge server
(0 -> 30 m through NLOS rooms) while episode-2 data arrives
asynchronously; at event 12 the manpack battery dies. Watch the
placement decisions flip and the failover keep recommendations flowing.
The port of ``examples/serve_episode.py``; runs on the CUDA card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_episode.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.emsnet import tiny
from repro_torch.core import (AdaptiveOffloadPolicy, BandwidthTrace, EMSServe,
                              HeartbeatMonitor, ProfileTable, emsnet_module,
                              nlos_bandwidth, profile, split, table6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    dev = _device.resolve(ap.parse_args(argv).device)
    cfg = tiny()
    modules = {
        "m1": emsnet_module(cfg, ("text",)),
        "m2": emsnet_module(cfg, ("text", "vitals")),
        "m3": emsnet_module(cfg, ("text", "vitals", "scene")),
    }
    models = {k: split(m) for k, m in modules.items()}
    params = {k: m.init_fn(torch.Generator().manual_seed(i), device=dev)
              for i, (k, m) in enumerate(modules.items())}

    rng = np.random.default_rng(1)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, cfg.max_text_len)).astype(np.int32),
        "vitals": rng.normal(size=(1, cfg.vitals_len,
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }

    # profile once offline, then drive decisions from it (paper §4.2.2)
    base = profile(models["m3"], params["m3"], payloads, device=dev)
    trace = BandwidthTrace.walk(np.linspace(0, 30, 21), nlos_bandwidth)
    policy = AdaptiveOffloadPolicy(ProfileTable(base=base),
                                   HeartbeatMonitor(trace))

    engine = EMSServe(models, params, policy=policy, cached=True, device=dev)
    for i, ev in enumerate(table6()[2]):
        if i == 12:
            print("-- manpack battery died: edge crash, failing over "
                  "on-glass --")
            engine.crash_edge()
        rec = engine.on_event(ev, payloads[ev.modality])
        out = ""
        if rec.recommendation is not None:
            r = rec.recommendation
            out = (f" protocol={int(torch.argmax(r['protocol_logits']))}"
                   f" medicine={int(torch.argmax(r['medicine_logits']))}")
        print(f"[{i:2d}] {ev.modality:6s} -> {rec.tier:5s}"
              f"  transfer={rec.delta_t * 1e3:7.1f}ms"
              f"  compute={rec.compute_s * 1e3:7.1f}ms"
              f"  model={rec.model or '-':3s}{out}")

    print(f"\ncumulative: {engine.cumulative_time() * 1e3:.1f} ms, "
          f"cache hits: {engine.cache.hits}, entries: {len(engine.cache)} "
          f"on {dev.type}")


if __name__ == "__main__":
    main()
