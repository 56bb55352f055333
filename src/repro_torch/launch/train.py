"""Training launcher: end-to-end EMSNet training on the synthetic
NEMSIS-schema datasets.

``--model emsnet`` (the default) runs D1 (2-modal) pretraining, then PMI
3-modal integration on D2, evaluation on held-out test splits and a
``{"m2", "m3"}`` checkpoint in the reference's format (``--out``).
``--text-encoder bertbase`` gives the ~110M-parameter configuration.
``--model <arch-id>`` (LM training of the architecture zoo) belongs to
ROADMAP item 11 and exits naming it.

Runs on the CUDA card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --text-encoder microbert --steps 20 --d1-size 600 --d2-size 200
"""
from __future__ import annotations

import argparse
import time


def train_emsnet(args):
    from .. import device as _device
    from ..configs.emsnet import config as emsnet_config
    from ..data import synthetic_nemsis as D
    from ..training import checkpoint as CKPT
    from ..training import emsnet_trainer as ET

    dev = _device.resolve(args.device)
    cfg = emsnet_config(text_encoder=args.text_encoder,
                        vitals_encoder=args.vitals_encoder,
                        vocab_size=2048)
    print(f"EMSNet {cfg.text_encoder}-{cfg.vitals_encoder}-fc on {dev}")
    d1 = D.generate(cfg, args.d1_size, seed=0)
    tr1, va1, te1 = D.splits(d1)
    print(f"D1 (2-modal): {len(d1)} samples -> {len(tr1)}/{len(va1)}/{len(te1)}")

    t0 = time.time()
    loader1 = D.loader(tr1, args.batch, modalities=("text", "vitals"))
    params2, _ = ET.train(cfg, loader1, modalities=("text", "vitals"),
                          steps=args.steps, lr=args.lr,
                          log_every=max(args.steps // 5, 1), device=dev)
    m2 = ET.evaluate(params2, cfg, te1, ("text", "vitals"))
    print(f"2-modal test ({time.time()-t0:.0f}s):",
          {k: round(v, 3) for k, v in m2.items()})

    d2 = D.generate(cfg, args.d2_size, seed=7, modal3=True)
    tr2, va2, te2 = D.splits(d2)
    loader2 = D.loader(tr2, min(args.batch, 32))
    params3, _ = ET.pmi_finetune(cfg, params2, loader2,
                                 steps=max(args.steps // 2, 50), lr=args.lr)
    m3 = ET.evaluate(params3, cfg, te2, ("text", "vitals", "scene"))
    print("3-modal PMI test:", {k: round(v, 3) for k, v in m3.items()})

    if args.out:
        CKPT.save(args.out, {"m2": params2, "m3": params3},
                  metadata={"cfg": str(ET.train_config(cfg)),
                            "metrics2": m2, "metrics3": m3})
        print(f"checkpoint -> {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="emsnet")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--text-encoder", default="tinybert")
    ap.add_argument("--vitals-encoder", default="gru")
    ap.add_argument("--d1-size", type=int, default=8000)
    ap.add_argument("--d2-size", type=int, default=600)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.model != "emsnet":
        raise SystemExit(f"--model {args.model}: LM training belongs to "
                         "ROADMAP queue 1 item 11 (the LLM zoo's last "
                         "part), which the port does not have yet")
    train_emsnet(args)


if __name__ == "__main__":
    main()
