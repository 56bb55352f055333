"""MultimodalModule protocol: the contract the modality-aware splitter
operates on.

A multimodal multitask model is declared as named per-modality encoder
functions plus a fused tail (fusion + task heads), each a function over
its own parameter subtree. EMSNet is the paper's instance.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Callable, Dict, Optional

from ..models import emsnet as E

ALL_MODALITIES = E.ALL_MODALITIES


@dataclass(frozen=True)
class MultimodalModule:
    name: str
    modalities: tuple                          # ordering defines fusion concat
    encoder_fns: Dict[str, Callable]           # m -> fn(params, inputs) -> feature
    tail_fn: Callable                          # fn(params, {m: feature}) -> outputs
    init_fn: Callable                          # fn(generator, *, device) -> params
    # representative input sizes in bytes, used by the offloading policy
    payload_bytes: Dict[str, int] = field(default_factory=dict)
    # hard per-modality input-length caps (e.g. a positional-embedding
    # table); the serving bucketer must never pad past these
    max_lengths: Dict[str, int] = field(default_factory=dict)
    # encoded-feature widths per modality (the F_C slice layout)
    feature_dims: Dict[str, int] = field(default_factory=dict)
    # int8 sidecar derivation; always None until the quantized glass
    # tier is ported
    quantize_fn: Optional[Callable] = None

    def full_fn(self):
        """The monolithic forward — what a conventional framework runs."""
        def fn(params, batch):
            feats = {m: self.encoder_fns[m](params, batch[m])
                     for m in self.modalities}
            return self.tail_fn(params, feats)
        return fn


def _encoder(cfg, m):
    return lambda params, inputs: E.encode(params, cfg, m, inputs)


def emsnet_module(cfg, modalities=ALL_MODALITIES) -> MultimodalModule:
    """Wrap EMSNet into the protocol."""
    payload = {
        "text": 16000 * 30,        # ~order of a short speech clip (bytes)
        "vitals": cfg.vitals_len * cfg.n_vitals * 4,
        "scene": 640 * 480 * 3,    # a scene image
    }
    return MultimodalModule(
        name=f"emsnet-{cfg.text_encoder}-{cfg.vitals_encoder}-fc",
        modalities=tuple(modalities),
        encoder_fns={m: _encoder(cfg, m) for m in modalities},
        tail_fn=lambda params, feats: E.fuse_and_heads(
            params["heads"], feats, modalities),
        init_fn=lambda gen, *, device: E.init_params(cfg, gen, modalities,
                                                     device=device),
        payload_bytes={m: payload[m] for m in modalities},
        max_lengths=({"text": cfg.max_text_len} if "text" in modalities
                     else {}),
        feature_dims={m: cfg.feature_dims[m] for m in modalities},
    )


def emsnet_subset_module(cfg, subset,
                         all_modalities=ALL_MODALITIES) -> MultimodalModule:
    """An EMSNet view over a modality *subset* that runs on the FULL
    model's parameters: the encoders are the full model's, the tail
    slices the full fusion heads to the subset's rows
    (``models.emsnet.slice_heads``), and ``init_fn`` inits the full
    model, so one parameter dict serves every subset."""
    subset = tuple(m for m in all_modalities if m in set(subset))

    def tail(params, feats):
        ph = E.slice_heads(params["heads"], cfg, all_modalities, subset)
        return E.fuse_and_heads(ph, feats, subset)

    base = emsnet_module(cfg, all_modalities)
    return MultimodalModule(
        name=f"{base.name}[{'+'.join(subset)}]",
        modalities=subset,
        encoder_fns={m: _encoder(cfg, m) for m in subset},
        tail_fn=tail,
        init_fn=base.init_fn,
        payload_bytes={m: base.payload_bytes[m] for m in subset},
        max_lengths={m: n for m, n in base.max_lengths.items()
                     if m in subset},
        feature_dims={m: base.feature_dims[m] for m in subset},
    )


def emsnet_zoo(cfg, all_modalities=ALL_MODALITIES):
    """Subset modules for every non-empty modality combination, keyed
    ``"text+vitals"``-style, all over one full-model parameter dict."""
    zoo = {}
    for r in range(1, len(all_modalities) + 1):
        for subset in combinations(all_modalities, r):
            zoo["+".join(subset)] = emsnet_subset_module(
                cfg, subset, all_modalities)
    return zoo
