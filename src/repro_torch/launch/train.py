"""Training launcher. Two modes, matching the paper's workload (EMSNet)
and the architecture zoo:

  * ``--model emsnet`` (the default): D1 (2-modal) pretraining on the
    synthetic NEMSIS-schema datasets, then PMI 3-modal integration on D2,
    evaluation on held-out test splits and a ``{"m2", "m3"}`` checkpoint
    in the reference's format (``--out``). ``--text-encoder bertbase``
    gives the ~110M-parameter configuration.

  * ``--model <arch-id> [--reduced]``: the LM training loop of any
    registry architecture on seeded random token streams (``--batch``,
    ``--seq``, ``--steps``), through ``training.trainer.make_train_step``
    with the config's optimizer; a conditioned arch gets seeded
    ``cond`` features.

Runs on the CUDA card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --text-encoder microbert --steps 20 --d1-size 600 --d2-size 200
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --model rwkv6-1.6b --reduced --steps 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np


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


def train_llm(args):
    import torch

    from .. import device as _device
    from ..configs import get_config, reduced
    from ..models import transformer as T
    from ..training.trainer import make_train_step

    dev = _device.resolve(args.device)
    cfg = get_config(args.model)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params on {dev}")
    step_fn, opt_init = make_train_step(cfg)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    opt_state = opt_init(params)
    rng = np.random.default_rng(0)
    B, S = args.batch, args.seq
    for i in range(args.steps):
        shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
        toks = rng.integers(0, cfg.vocab_size, size=(shape[0], shape[1] + 1)
                            + shape[2:]).astype(np.int32)
        toks = torch.from_numpy(toks).to(dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.cond_dim:
            batch["cond"] = torch.from_numpy(rng.normal(
                size=(B, cfg.cond_seq_len, cfg.cond_dim)).astype(
                    np.float32)).to(dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % max(args.steps // 5, 1) == 0:
            print(f"step {i+1}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="emsnet")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--text-encoder", default="tinybert")
    ap.add_argument("--vitals-encoder", default="gru")
    ap.add_argument("--d1-size", type=int, default=8000)
    ap.add_argument("--d2-size", type=int, default=600)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.model == "emsnet":
        train_emsnet(args)
    else:
        train_llm(args)


if __name__ == "__main__":
    main()
