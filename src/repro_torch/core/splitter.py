"""Modality-aware model splitter (EMSServe §4.2.1).

Decomposes a MultimodalModule into independently callable
single-modality encoders plus a fused tail. The split boundary is a dict
of feature tensors, so each piece runs on its own — which is what lets
EMSServe (a) run one modality the moment it arrives, (b) cache its
output feature, and (c) place each piece on a different tier.

The pieces run eagerly (the reference jits each one). ``split`` also
returns the monolithic forward — the "direct PyTorch" baseline the
paper compares against.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from .. import device as _device
from .modular import MultimodalModule


@dataclass
class SplitModel:
    module: MultimodalModule
    encoders: Dict[str, Callable]     # per-modality: (params, x) -> feature
    tail: Callable                    # (params, feats) -> outputs
    full: Callable                    # monolithic forward (baseline)

    def modalities(self):
        return self.module.modalities

    def compile_count(self) -> int:
        """Compiled programs across this model's pieces: 0, since the
        pieces run eagerly."""
        return 0

    def quantize_params(self, params):
        """Derive the int8 sidecar dict the SAME encoders accept
        (``layers.dense`` dispatches on the sidecar leaf form). Raises for
        modules without a quantized variant: a precision-enabled spec over
        such a model is a configuration error, not a quiet float32
        fallback."""
        if self.module.quantize_fn is None:
            raise ValueError(
                f"model {self.module.name!r} declares no quantize_fn; "
                "it cannot serve an int8 precision tier")
        return self.module.quantize_fn(params)


def select_model(models: Dict[str, SplitModel], observed) -> str | None:
    """EMSServe's model-selection rule (paper §4.2): the model consuming
    the most modalities whose inputs have all been observed.

    Ties break on the lexicographically greatest sorted modality tuple,
    then the model name — NOT on dict insertion order, so two engines
    built from differently-ordered zoos always pick the same model."""
    obs = set(observed)
    best, best_key = None, None
    for name, sm in models.items():
        mods = set(sm.modalities())
        if mods <= obs:
            key = (len(mods), tuple(sorted(mods)), name)
            if best_key is None or key > best_key:
                best, best_key = name, key
    return best


def split(module: MultimodalModule) -> SplitModel:
    return SplitModel(module=module, encoders=dict(module.encoder_fns),
                      tail=module.tail_fn, full=module.full_fn())


def profile(split_model: SplitModel, params, sample_batch: dict, *,
            iters: int = 5, device="cuda") -> Dict[str, float]:
    """One-time offline inference-time profiling (EMSServe §4.2.2).

    Returns wall-seconds per submodule (and the monolithic model) on
    ``device`` — the `t^e` column; tier tables derive `t^g` from it.
    ``params`` must already be on ``device``; the sample batch is moved
    there. On CUDA the card is synchronised before each clock read."""
    dev = _device.resolve(device)
    batch = {m: torch.as_tensor(x, device=dev) for m, x in sample_batch.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(fn, *args):
        fn(*args)                          # warm-up (kernel build, caches)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        return (time.perf_counter() - t0) / iters

    times, feats = {}, {}
    with torch.inference_mode():
        for m in split_model.modalities():
            times[f"enc:{m}"] = bench(split_model.encoders[m], params,
                                      batch[m])
            feats[m] = split_model.encoders[m](params, batch[m])
        times["tail"] = bench(split_model.tail, params, feats)
        times["full"] = bench(split_model.full, params, batch)
    return times


def payload_nbytes(tree) -> int:
    """Serialized size in bytes of a tree (dicts, lists, tuples) of
    tensors or numpy arrays: ``numel * element_size`` per array leaf,
    8 bytes per Python scalar. THE one byte-sizing rule, as in the
    reference."""
    if isinstance(tree, dict):
        return sum(payload_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(payload_nbytes(v) for v in tree)
    if tree is None:                       # an empty subtree, as in JAX
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (np.ndarray, np.generic)):
        return tree.size * tree.itemsize
    return 8


def feature_sizes(split_model: SplitModel, params,
                  sample_batch: dict) -> Dict[str, int]:
    """On-wire bytes of each modality's encoded feature (and the tail's
    head outputs under ``"outputs"``) for a representative batch, sized
    from the real tensors by :func:`payload_nbytes`."""
    with torch.inference_mode():
        feats = {m: split_model.encoders[m](params, sample_batch[m])
                 for m in split_model.modalities()}
        sizes = {m: payload_nbytes(f) for m, f in feats.items()}
        sizes["outputs"] = payload_nbytes(split_model.tail(params, feats))
    return sizes
