"""Quickstart on the PyTorch port: EMSNet + EMSServe in ~60 lines.

Builds the paper's three models (M1 text, M2 text+vitals, M3
text+vitals+scene), splits them with the modality-aware splitter, and
streams paper Table-6 episode 1 through the EMSServe engine twice —
direct (re-inference of every modality) vs cached — printing the
speedup. The port of ``examples/quickstart.py``; runs on the CUDA card
unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.emsnet import tiny
from repro_torch.core import EMSServe, emsnet_module, profile, split, table6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    dev = _device.resolve(ap.parse_args(argv).device)
    cfg = tiny()

    # --- build + split the multimodal models (paper Fig. 9: M1/M2/M3) ----
    modules = {
        "m1": emsnet_module(cfg, ("text",)),
        "m2": emsnet_module(cfg, ("text", "vitals")),
        "m3": emsnet_module(cfg, ("text", "vitals", "scene")),
    }
    models = {k: split(m) for k, m in modules.items()}
    params = {k: m.init_fn(torch.Generator().manual_seed(i), device=dev)
              for i, (k, m) in enumerate(modules.items())}

    # --- sample multimodal payloads (stub frontends) ----------------------
    rng = np.random.default_rng(0)
    payloads = {
        "text": rng.integers(1, cfg.vocab_size,
                             (1, cfg.max_text_len)).astype(np.int32),
        "vitals": rng.normal(size=(1, cfg.vitals_len,
                                   cfg.n_vitals)).astype(np.float32),
        "scene": rng.integers(0, 2, (1, cfg.scene_dim)).astype(np.float32),
    }

    # --- one-time offline profiling (paper §4.2.2) ------------------------
    prof = profile(models["m3"], params["m3"], payloads, device=dev)
    print("profile:", {k: f"{v * 1e3:.2f} ms" for k, v in prof.items()})

    # --- episode 1, direct vs cached --------------------------------------
    times = {}
    for cached in (False, True):
        for attempt in range(2):                  # 2nd run: graphs captured
            eng = EMSServe(models, params, cached=cached, real_time=True,
                           device=dev)
            eng.run_episode(table6()[1], lambda ev: payloads[ev.modality])
        times[cached] = eng.cumulative_time()
        last = eng.records[-1].recommendation
        print(f"{'cached' if cached else 'direct':6s}: "
              f"{times[cached] * 1e3:8.1f} ms cumulative, "
              f"final protocol={int(torch.argmax(last['protocol_logits']))}")

    print(f"\nEMSServe speedup over direct multimodal inference: "
          f"{times[False] / times[True]:.2f}x  (paper: 1.9x-11.7x) on "
          f"{dev.type}")


if __name__ == "__main__":
    main()
