"""Attention of the LLM zoo: GQA self-attention with sliding windows,
cross-attention over conditioning features, DeepSeek's multi-head latent
attention (MLA) and the ring-buffer decode caches.

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

MLA follows the reference: prefill decompresses the latents and runs
``flash_attention_plain`` with a query/key head dim (``qk_nope +
qk_rope``, 192 at full width) other than the value's (``v_dim``, 128),
whatever ``kernel`` says, as the reference's ``mla_forward`` runs its
plain blocked attention whatever ``kernel`` says (the CUDA flash kernel
takes one head dim for q, k and v, up to 128). Decode is the absorbed
form: scores and context in the latent space, float32, against a ring
buffer of latents (``ckv``, ``krope``, ``pos``) written in place. The
reference writes neither in a Pallas kernel, so neither has one here.

Cross-attention (Llama-3.2-Vision's gated layers, MusicGen's
conditioning sublayer) follows the reference too: ``cross_kv`` projects
the conditioning features to keys and values once (the decode cache
keeps them), and ``cross_attn_forward`` attends every query to every
conditioning position through ``flash_attention_plain(causal=False)``
on prefill and decode alike, as the reference's calls its plain blocked
attention and takes no kernel switch. A cross projection has no bias.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from ..kernels.decode_attention import decode_attention_plain
from ..kernels.flash_attention import NEG_INF, flash_attention_plain
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
# GQA self-attention and cross-attention
# ----------------------------------------------------------------------

def attn_init(gen, cfg, *, cross=False, device):
    """``cross``: a cross-attention projection, never with a QKV bias."""
    d = cfg.d_model
    dt = L.pdtype(cfg)
    kw = dict(bias=cfg.qkv_bias and not cross, dtype=dt, device=device)
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


def cross_attn_forward(p, x, cond_kv, cfg):
    """Cross-attention of ``x`` (B, S, d) over conditioning keys and
    values ``cond_kv`` = (k, v), each (B, Cs, KV, D) from ``cross_kv``:
    every query sees every conditioning position."""
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    q = L.dense(p["wq"], x).reshape(B, S, H, D)
    k, v = cond_kv
    out = flash_attention_plain(q, k, v, causal=False)
    return L.dense(p["wo"], out.reshape(B, S, H * D))


def cross_kv(p, cond, cfg):
    """Project conditioning embeddings (B, Cs, d) to (k, v), each (B, Cs,
    KV, D): once a prompt, cached thereafter."""
    B, Cs, _ = cond.shape
    KV, D = cfg.n_kv_heads, cfg.head_dim
    k = L.dense(p["wk"], cond).reshape(B, Cs, KV, D)
    v = L.dense(p["wv"], cond).reshape(B, Cs, KV, D)
    return k, v


def cross_cache_init(cfg, batch, dtype, *, device):
    """A cross layer's cache: the conditioning keys and values."""
    shape = (batch, cfg.cond_seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_cache_init(cfg, batch, length, dtype, *, device):
    KV, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, KV, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, KV, D), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


# ----------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ----------------------------------------------------------------------

def mla_init(gen, cfg, *, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    kw = dict(dtype=L.pdtype(cfg), device=device)
    return {
        "wq_a": L.dense_init(gen, d, m.q_lora_rank, **kw),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, **kw),
        "wq_b": L.dense_init(gen, m.q_lora_rank,
                             H * (m.qk_nope_dim + m.qk_rope_dim), **kw),
        "wkv_a": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, **kw),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, **kw),
        "wk_b": L.dense_init(gen, m.kv_lora_rank, H * m.qk_nope_dim, **kw),
        "wv_b": L.dense_init(gen, m.kv_lora_rank, H * m.v_dim, **kw),
        "wo": L.dense_init(gen, H * m.v_dim, d, **kw),
    }


def _mla_q(p, x, positions, cfg):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q = L.dense(p["wq_b"], L.rmsnorm(p["q_norm"], L.dense(p["wq_a"], x)))
    q = q.reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, positions, cfg):
    m = cfg.mla
    kv = L.dense(p["wkv_a"], x)
    ckv = L.rmsnorm(p["kv_norm"], kv[..., :m.kv_lora_rank])
    k_rope = L.apply_rope(kv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return ckv, k_rope


def _mla_scale(m):
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def mla_forward(p, x, positions, cfg, *, window=0, kernel="jnp"):
    """Prefill: decompress the latents and run MHA. Returns (out, (ckv,
    k_rope)). ``kernel`` is taken and, as in the reference, not read."""
    if kernel not in ("jnp", "pallas"):
        raise ValueError(f"kernel={kernel!r}: 'jnp' or 'pallas'")
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    ckv, k_rope = _mla_ckv(p, x, positions, cfg)
    wk_b = p["wk_b"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    wv_b = p["wv_b"]["w"].reshape(m.kv_lora_rank, H, m.v_dim)
    k_nope = torch.einsum("bsr,rhn->bshn", ckv, wk_b)
    vdec = torch.einsum("bsr,rhv->bshv", ckv, wv_b)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    out = flash_attention_plain(q, k, vdec, causal=True, window=window,
                                scale=_mla_scale(m))
    out = L.dense(p["wo"], out.reshape(B, S, H * m.v_dim))
    return out, (ckv, k_rope)


def mla_decode(p, x, cache, t, cfg, *, window=0):
    """Absorbed-matrix decode against the latent cache: scores and context
    computed in the kv_lora latent space, float32. cache: {ckv, krope,
    pos}, written in place. Returns (out, cache)."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    t = position_tensor(t, x.device)
    tpos = t.reshape(1, 1).expand(B, 1)
    q_nope, q_rope = _mla_q(p, x, tpos, cfg)           # (B, 1, H, *)
    ckv_new, krope_new = _mla_ckv(p, x, tpos, cfg)     # (B, 1, r), (B, 1, p)
    cbuf = ring_write(cache["ckv"], ckv_new, t)
    rbuf = ring_write(cache["krope"], krope_new, t)
    pos = ring_write(cache["pos"][None], t.reshape(1, 1), t)[0]

    wk_b = p["wk_b"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_dim).float()
    wv_b = p["wv_b"]["w"].reshape(m.kv_lora_rank, H, m.v_dim).float()
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), wk_b)
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat, cbuf.float())
         + torch.einsum("bqhp,bkp->bhqk", q_rope.float(), rbuf.float()))
    s = s * _mla_scale(m)
    valid = (pos >= 0) & (pos <= t)
    if window:
        valid &= t - pos < window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", w, cbuf.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx, wv_b)
    out = L.dense(p["wo"], out.reshape(B, 1, H * m.v_dim).to(x.dtype))
    return out, {"ckv": cbuf, "krope": rbuf, "pos": pos}


def mla_cache_init(cfg, batch, length, dtype, *, device):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, length, m.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
