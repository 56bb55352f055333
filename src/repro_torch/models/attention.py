"""Attention of the LLM zoo: GQA self-attention with sliding windows and
the ring-buffer decode cache.

Prefill attention follows the reference's kernel switch:
``kernel="jnp"`` (the default, and what the reference's server runs) is
``flash_attention_plain``, masked softmax attention in plain PyTorch,
the same function as the reference's blocked ``flash_attention_jnp`` up
to rounding; ``kernel="pallas"`` is ``kernels.ops.flash_attention``, the
hand-written CUDA kernel on the card (the reference's Pallas kernel),
its plain version on the CPU. Decode attends one new token against
a fixed-size ring buffer through ``kernels.ops.decode_attention``: the
hand-written CUDA kernel on the card, ``plain_attention_vs_cache`` on the
CPU. A slot is
valid iff its stored position is in ``[t - window, t]``, so the same code
serves a full cache and a sliding-window one.

Decode writes the new token's K, V and position into the cache IN PLACE
(the reference's arrays are immutable and it returns new ones); callers
that keep a cache for later (the server's prefix cache) store a copy.

MLA (DeepSeek) and cross-attention are not ported yet (ROADMAP item 11).
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from ..kernels.decode_attention import decode_attention_plain
from ..kernels.flash_attention import flash_attention_plain
from . import layers as L

# the oracle of the decode kernel is its plain version
plain_attention_vs_cache = decode_attention_plain


def position_tensor(t, device):
    """The decode position as a 0-d int32 tensor on ``device``. A tensor
    is moved (no copy when it is one already); an int is written there
    by a fill kernel, not copied from the host, so a decode step never
    waits for the card."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.int32)
    return torch.full((), t, dtype=torch.int32, device=device)


def ring_write(buf, new, t):
    """Write ``new`` (B, 1, ...) at slot t % W of ``buf`` (B, W, ...), in
    place; returns ``buf``."""
    slot = torch.remainder(position_tensor(t, buf.device), buf.shape[1]).reshape(1)
    return buf.index_copy_(1, slot.long(), new.to(buf.dtype))


# ----------------------------------------------------------------------
# GQA self-attention
# ----------------------------------------------------------------------

def attn_init(gen, cfg, *, device):
    d = cfg.d_model
    dt = L.pdtype(cfg)
    kw = dict(bias=cfg.qkv_bias, dtype=dt, device=device)
    return {
        "wq": L.dense_init(gen, d, cfg.q_dim, **kw),
        "wk": L.dense_init(gen, d, cfg.kv_dim, **kw),
        "wv": L.dense_init(gen, d, cfg.kv_dim, **kw),
        "wo": L.dense_init(gen, cfg.q_dim, d, dtype=dt, device=device),
    }


def attn_forward(p, x, positions, cfg, *, window=0, kernel="jnp"):
    """Prefill self-attention. Returns (out, (k, v))."""
    if kernel not in ("jnp", "pallas"):
        raise ValueError(f"kernel={kernel!r}: 'jnp' or 'pallas'")
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(p["wq"], x).reshape(B, S, H, D)
    k = L.dense(p["wk"], x).reshape(B, S, KV, D)
    v = L.dense(p["wv"], x).reshape(B, S, KV, D)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if kernel == "pallas":
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = flash_attention_plain(q, k, v, causal=True, window=window)
    return L.dense(p["wo"], out.reshape(B, S, H * D)), (k, v)


def attn_decode(p, x, cache, t, cfg, *, window=0):
    """One-token decode. x: (B, 1, d); cache: {k, v, pos}, written in
    place; t: the position (int or 0-d tensor). Returns (out, cache)."""
    B = x.shape[0]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = position_tensor(t, x.device)
    tpos = t.reshape(1, 1).expand(B, 1)
    q = L.dense(p["wq"], x).reshape(B, 1, H, D)
    k = L.dense(p["wk"], x).reshape(B, 1, KV, D)
    v = L.dense(p["wv"], x).reshape(B, 1, KV, D)
    q = L.apply_rope(q, tpos, cfg.rope_theta)
    k = L.apply_rope(k, tpos, cfg.rope_theta)
    kbuf = ring_write(cache["k"], k, t)
    vbuf = ring_write(cache["v"], v, t)
    pos = ring_write(cache["pos"][None], t.reshape(1, 1), t)[0]
    out = kops.decode_attention(q, kbuf, vbuf, pos, t, window=window,
                                scale=1.0 / math.sqrt(D))
    out = L.dense(p["wo"], out.reshape(B, 1, H * D))
    return out, {"k": kbuf, "v": vbuf, "pos": pos}


def attn_cache_init(cfg, batch, length, dtype, *, device):
    KV, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, KV, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, KV, D), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
