"""Composable decoder of the LLM zoo: assembles layer groups from a
ModelConfig.

A config declares ``groups = ((period_specs, count), ...)``. Parameters
of each group are stacked along a leading ``count`` axis, the reference's
tree layout (``params["groups"]["0"]["0"]["mixer"]["wq"]["w"]`` is
``(count, d, q_dim)``), so converted reference weights drop in unchanged.
Where the reference runs a group with ``lax.scan``, the port loops over
the leading axis in Python. Decode caches are stacked the same way.

Entry points:
  init_params(cfg, gen, device=...)
  prefill(params, cfg, tokens, ..., kernel="jnp") -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache, t, ...) -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=...)

``decode_step`` writes the new token's entries into ``cache`` in place
and returns it; keep a copy of a cache that must outlive the step.
``prefill(kernel="pallas")`` runs the prompt's attention through the
hand-written flash kernel (``kernels.flash_attention``), the reference's
switch to its Pallas kernel; ``"jnp"`` (the default, as there) runs the
plain attention.

Ported mixers: ``attn`` (GQA, QKV bias, sliding windows) and ``rwkv6``;
MLPs: ``dense`` (swiglu, relu2), ``moe`` (sort-based dispatch, optional
shared experts; its load-balance loss is dropped on prefill and decode,
as the reference drops it) and ``rwkv_cmix``. MLA, Mamba,
cross-attention, the conditioning sublayer, musicgen codebooks,
conditioning frontends and multi-token prediction raise
``NotImplementedError`` naming ROADMAP item 11, where they are queued.
"""
from __future__ import annotations

import torch

from . import attention as A
from . import layers as L
from . import moe as M
from . import rwkv as R


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP item 11)")


def _check_spec(spec):
    if spec.mixer not in ("attn", "rwkv6"):
        _not_ported(f"mixer {spec.mixer!r}")
    if spec.cross:
        _not_ported("the conditioning cross-attention sublayer (spec.cross)")
    if spec.mlp not in ("dense", "moe", "rwkv_cmix", "none"):
        _not_ported(f"mlp {spec.mlp!r}")


def _check_cfg(cfg):
    if cfg.n_codebooks != 1:
        _not_ported("multi-codebook (musicgen) embeddings")
    if cfg.cond_dim:
        _not_ported("a conditioning frontend (cond_dim)")
    if cfg.mtp:
        _not_ported("multi-token prediction")
    for specs, _ in cfg.groups:
        for spec in specs:
            _check_spec(spec)


# ----------------------------------------------------------------------
# Trees
# ----------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree, i):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return _tree_map(lambda a: a[i], tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _write(dst, src):
    """Copy each leaf of ``src`` into the same leaf of ``dst`` (views into
    a stacked tree), skipping leaves that already are the destination."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def clone(tree):
    """A deep copy of a tree of tensors (a cache snapshot)."""
    return _tree_map(torch.clone, tree)


def copy_cache(dst, src):
    """Copy cache ``src`` into ``dst`` in place, leaf by leaf: the same
    keys, shapes and dtypes (a server's static cache). Returns ``dst``."""
    for k, d in dst.items():
        s = src[k]
        if isinstance(d, dict):
            copy_cache(d, s)
        elif d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"cache leaf {k!r}: {tuple(s.shape)} {s.dtype} "
                             f"into {tuple(d.shape)} {d.dtype}")
        else:
            d.copy_(s)
    return dst


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def init_layer(gen, cfg, spec, *, device):
    _check_spec(spec)
    d = cfg.d_model
    dt = L.pdtype(cfg)
    p = {"norm1": L.rmsnorm_init(d, dt, device=device)}
    if spec.mixer == "attn":
        p["mixer"] = A.attn_init(gen, cfg, device=device)
    else:
        p["mixer"] = R.rwkv6_init(gen, cfg, device=device)
    if spec.mlp != "none":
        p["norm2"] = L.rmsnorm_init(d, dt, device=device)
    if spec.mlp == "dense":
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dtype=dt,
                              device=device)
    elif spec.mlp == "moe":
        p["mlp"] = M.moe_init(gen, cfg, device=device)
    elif spec.mlp == "rwkv_cmix":
        p["mlp"] = R.cmix_init(gen, cfg, device=device)
    return p


def _init_group(gen, cfg, specs, count, *, device):
    """``count`` periods stacked on a leading axis. The stacked leaves are
    allocated once and filled period by period, so the peak is the stack
    plus one period (a full-size model is never held twice)."""
    def period():
        return {str(i): init_layer(gen, cfg, s, device=device)
                for i, s in enumerate(specs)}

    first = period()
    out = _tree_map(lambda a: torch.empty((count,) + a.shape, dtype=a.dtype,
                                          device=a.device), first)
    _write(_index(out, 0), first)
    for i in range(1, count):
        _write(_index(out, i), period())
    return out


def init_params(cfg, gen: torch.Generator, *, device):
    """Random weights from ``gen``, drawn on the generator's device (see
    ``layers.normal``) and stored on ``device`` in ``cfg.dtype``."""
    _check_cfg(cfg)
    d = cfg.d_model
    dt = L.pdtype(cfg)
    params = {
        "embed": {"emb": L.normal(gen, (cfg.n_codebooks, cfg.vocab_size, d),
                                  0.02, dtype=dt, device=device)},
        "final_norm": L.rmsnorm_init(d, dt, device=device),
        "groups": {},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dtype=dt,
                                         device=device)
    for gi, (specs, count) in enumerate(cfg.groups):
        params["groups"][str(gi)] = _init_group(gen, cfg, specs, count,
                                                device=device)
    return params


# ----------------------------------------------------------------------
# Layer application
# ----------------------------------------------------------------------

def _pack_ring(full, positions, Wc):
    """Pack per-position arrays (B, S, ...) into a ring buffer (B, Wc, ...).

    Keeps the last min(S, Wc) positions; the slot of position p is
    p % Wc. Returns (buffer, slot_positions (Wc,) int32)."""
    B, Sq = full.shape[0], full.shape[1]
    n = min(Sq, Wc)
    tail = full[:, Sq - n:]
    tail_pos = positions[Sq - n:]
    slots = torch.remainder(tail_pos, Wc).long()
    buf = torch.zeros((B, Wc) + tuple(full.shape[2:]), dtype=full.dtype,
                      device=full.device)
    buf[:, slots] = tail
    pos = torch.full((Wc,), -1, dtype=torch.int32, device=full.device)
    pos[slots] = tail_pos.to(torch.int32)
    return buf, pos


def apply_layer(lp, spec, x, ctx, mode, cache, t):
    """``mode`` is "prefill" or "decode"; ``spec`` one the entry points
    have checked (``_check_cfg``). Returns (x, new_cache)."""
    cfg = ctx["cfg"]
    new_cache = {}
    window = spec.window or (ctx["window_attn"] if spec.mixer == "attn" else 0)

    # ---- mixer sublayer ----
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        if mode == "decode":
            mix, new_cache["kv"] = A.attn_decode(lp["mixer"], h, cache["kv"],
                                                 t, cfg, window=window)
        else:
            mix, kv = A.attn_forward(lp["mixer"], h, ctx["positions"], cfg,
                                     window=window, kernel=ctx["kernel"])
            new_cache["kv"] = _prefill_kv_cache(kv, ctx)
    elif spec.mixer == "rwkv6":
        prev = cache["rwkv"] if mode == "decode" else None
        mix, (last_x, state) = R.rwkv6_tmix(
            lp["mixer"], h, cfg,
            state=prev["state"] if prev else None,
            x_prev=prev["tshift"] if prev else None)
        new_cache["rwkv"] = {"tshift": last_x, "state": state}
    x = x + mix

    # ---- mlp sublayer ----
    if spec.mlp != "none":
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        if spec.mlp == "dense":
            out = L.mlp(lp["mlp"], h, cfg.mlp_act)
        elif spec.mlp == "moe":
            if ctx["moe_pre"]:
                h = ctx["moe_pre"](h)
            out, _ = M.moe_forward(lp["mlp"], h, cfg)
        else:
            prev = cache["cmix"] if mode == "decode" else None
            out, new_cache["cmix"] = R.rwkv6_cmix(lp["mlp"], h, cfg,
                                                  x_prev=prev)
        x = x + out
    return x, new_cache


def _prefill_kv_cache(kv, ctx):
    Wc = ctx["cache_len"]
    positions = ctx["positions"]
    positions = positions[0] if positions.dim() == 2 else positions
    k, v = kv
    kb, pos = _pack_ring(k, positions, Wc)
    vb, _ = _pack_ring(v, positions, Wc)
    return {"k": kb, "v": vb, "pos": pos}


def apply_period(pp, specs, x, ctx, mode, cache, t):
    new_cache = {}
    for i, spec in enumerate(specs):
        lc = cache[str(i)] if cache is not None else None
        x, new_cache[str(i)] = apply_layer(pp[str(i)], spec, x, ctx, mode,
                                           lc, t)
    return x, new_cache


# ----------------------------------------------------------------------
# Forward passes
# ----------------------------------------------------------------------

def _embed_tokens(params, cfg, tokens):
    return params["embed"]["emb"][0][tokens.long()]


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"][0].T
    return L.dense(params["lm_head"], x)


def _make_ctx(cfg, positions, *, kernel="jnp", window_attn=0, cache_len=0,
              moe_pre=None):
    return {"cfg": cfg, "positions": positions, "kernel": kernel,
            "window_attn": window_attn, "cache_len": cache_len,
            "moe_pre": moe_pre}


def prefill(params, cfg, tokens, *, cache_len=None, window_attn=0,
            kernel="jnp"):
    """Process a full prompt (B, S); returns (last_token_logits (B, 1, V),
    cache). ``kernel``: "jnp" (plain attention) or "pallas" (the flash
    kernel)."""
    _check_cfg(cfg)
    B, Sq = tokens.shape[0], tokens.shape[1]
    if cache_len is None:
        cache_len = Sq
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=tokens.device).expand(B, Sq)
    x = _embed_tokens(params, cfg, tokens)
    ctx = _make_ctx(cfg, positions, kernel=kernel, window_attn=window_attn,
                    cache_len=cache_len)
    caches = {}
    for gi, (specs, count) in enumerate(cfg.groups):
        gp = params["groups"][str(gi)]
        layer_caches = []
        for i in range(count):
            x, nc = apply_period(_index(gp, i), specs, x, ctx, "prefill",
                                 None, None)
            layer_caches.append(nc)
        caches[str(gi)] = _stack(layer_caches)
    x = L.rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return _logits(params, cfg, x), caches


def decode_step(params, cfg, tokens, cache, t, *, window_attn=0,
                moe_pre=None):
    """One-token decode. tokens: (B, 1); t: the position (int or 0-d
    tensor). Writes the step into ``cache`` in place; returns (logits
    (B, 1, V), cache). ``moe_pre``: a callable applied to each MoE
    layer's input before its dispatch (the reference's hook)."""
    _check_cfg(cfg)
    x = _embed_tokens(params, cfg, tokens)
    t = A.position_tensor(t, x.device)
    ctx = _make_ctx(cfg, None, window_attn=window_attn, moe_pre=moe_pre)
    for gi, (specs, count) in enumerate(cfg.groups):
        gp, gc = params["groups"][str(gi)], cache[str(gi)]
        for i in range(count):
            lc = _index(gc, i)
            x, nc = apply_period(_index(gp, i), specs, x, ctx, "decode", lc, t)
            _write(lc, nc)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), cache


# ----------------------------------------------------------------------
# Cache init
# ----------------------------------------------------------------------

def init_layer_cache(cfg, spec, batch, cache_len, dtype, *, device):
    _check_spec(spec)
    c = {}
    if spec.mixer == "attn":
        c["kv"] = A.attn_cache_init(cfg, batch, cache_len, dtype, device=device)
    else:
        c["rwkv"] = R.rwkv6_cache_init(cfg, batch, dtype, device=device)
    if spec.mlp == "rwkv_cmix":
        c["cmix"] = torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                device=device)
    return c


def init_cache(cfg, batch, cache_len, dtype=None, *, device):
    _check_cfg(cfg)
    dtype = dtype or L.pdtype(cfg)
    caches = {}
    for gi, (specs, count) in enumerate(cfg.groups):
        period = {str(i): init_layer_cache(cfg, s, batch, cache_len, dtype,
                                           device=device)
                  for i, s in enumerate(specs)}
        caches[str(gi)] = _tree_map(
            lambda a: a[None].repeat((count,) + (1,) * a.dim()), period)
    return caches
