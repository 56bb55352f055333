"""Serving cache policy: per-arch cache length / sliding-window decisions.

The port of ``repro/serving/kv_cache.py``, the same decisions for the
``long_500k`` shape (S=524,288 decode):
  * SSM / RWKV layers: constant-size state, nothing to bound.
  * MLA (deepseek): the full latent cache (compressed, ~9x smaller than
    GQA KV).
  * hybrid (jamba): its attention layers keep full KV (cheap enough).
  * plain GQA layers of dense/audio/vlm/gqa-MoE archs: a sliding-window
    ring buffer of ``cfg.long_context_window``, the sub-quadratic variant
    long-context decode needs.
Every other shape decodes over a full cache of its sequence length.
"""
from __future__ import annotations

from ..configs.base import InputShape, ModelConfig

FULL_ATTN_LONG = {"hybrid"}          # arch types that keep full KV at 500k


def has_mixer(cfg: ModelConfig, mixer: str) -> bool:
    return any(s.mixer == mixer for specs, _ in cfg.groups for s in specs)


def uses_window(cfg: ModelConfig, shape: InputShape) -> bool:
    """Do plain-attn layers switch to the sliding window for this shape?"""
    if shape.name != "long_500k":
        return False
    if not has_mixer(cfg, "attn"):
        return False
    return cfg.arch_type not in FULL_ATTN_LONG


def cache_plan(cfg: ModelConfig, shape: InputShape):
    """Returns (cache_len, window_attn) for decode at this shape.

    cache_len is the ring-buffer length for attention-style caches;
    window_attn is the mask window applied to plain-attn layers
    (0 = full causal)."""
    if uses_window(cfg, shape):
        w = cfg.long_context_window
        return w, w
    return shape.seq_len, 0
