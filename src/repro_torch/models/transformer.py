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
  forward_train(params, cfg, tokens, cond=, next_tokens=, kernel="jnp")
      -> (logits, {"moe_aux", "mtp_logits"?})
  prefill(params, cfg, tokens, ..., kernel="jnp") -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache, t, ...) -> (logits, cache)
  init_cache(cfg, batch, cache_len, device=...)

``decode_step`` writes the new token's entries into ``cache`` in place
and returns it; keep a copy of a cache that must outlive the step.
``prefill(kernel="pallas")`` runs the prompt's attention through the
hand-written flash kernel (``kernels.flash_attention``), the reference's
switch to its Pallas kernel; ``"jnp"`` (the default, as there) runs the
plain attention.

Ported mixers: ``attn`` (GQA, QKV bias, sliding windows), ``mla``
(DeepSeek's latent attention: plain attention on prefill, whatever
``kernel`` says, as the reference's; the absorbed form on decode),
``mamba`` (Jamba's selective SSM, its cache the reference's
``(conv_state, ssm_state)`` tuple), ``rwkv6`` and ``cross_attn``
(Llama-3.2-Vision's gated cross-attention layer: ``tanh(gate_attn)``
times the attention over the conditioning features, its float32 gate
stacked ``(count,)``); MLPs: ``dense`` (swiglu, relu2), ``moe``
(sort-based dispatch, optional shared experts; its load-balance loss is
dropped on prefill and decode, as the reference drops it) and
``rwkv_cmix``. A ``spec.cross`` layer adds MusicGen's conditioning
sublayer (``norm_c``, ``cross``) between mixer and MLP.

Conditioning: a ``cond_dim`` config takes ``prefill(..., cond=(B, Cs,
cond_dim))``, cast to the weights' dtype and projected by ``cond_proj``;
each cross layer projects it to keys and values once, and the cache
keeps them (``cross`` for the mixer, ``cond`` for the sublayer), which
prefill fills and decode passes through unchanged, so a captured decode
graph reads them in place. Cross-attention is plain PyTorch whatever
``kernel`` says, as the reference's. A multi-codebook config
(``n_codebooks`` > 1, MusicGen) takes tokens (B, S, ncb), embeds them as
the sum of one table a codebook and returns logits (B, S, ncb, V).

Training. ``forward_train`` runs every layer in "train" mode: no cache
is built, and each MoE layer's load-balance loss is kept and summed into
``moe_aux``. With ``cfg.remat`` each period runs under
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint`` around its scan body: the backward recomputes the
period's forward, so a kernel inside it launches twice a step, and the
numbers do not change. An ``mtp`` config given ``next_tokens`` also runs
the multi-token prediction head (``params["mtp"]``, built by
``init_params``): one more layer of the last group's first kind over
``proj(cat(norm_h(h), norm_e(embed(next_tokens))))``, its logits under
``mtp_logits`` and its aux loss added. Prefill and decode never read it.
Training runs under autograd: ``kernel="pallas"`` reaches the flash
kernel, which has no backward and raises there, so training takes the
plain attention ("jnp"), as the reference's trainer does; the RWKV6 scan
carries its own backward kernel (``kernels.rwkv6``).

Sharding. The reference's hooks are taken as there: ``constrain`` (the
activation after the embedding and after every period, by
``forward_train`` and ``prefill``), ``moe_a2a`` (every MoE layer through
``moe.moe_forward_a2a``) and ``moe_pre`` (decode). With parameters
placed as DTensors (``launch.specs``) the entry points run SPMD over
their mesh: each piece (the embedding, a period, the head) runs on each
rank's batch rows with its weights gathered (``distributed.spmd``), so
every kernel sees plain local tensors, a MoE layer without ``moe_a2a``
dispatches every rank's tokens (as GSPMD runs the reference's over the
global batch), prefill returns the cache as DTensors and decode writes a
placed cache through its local blocks. DTensor views are not taken
under ``inference_mode``: serve a placed model under ``no_grad``. With
plain tensors nothing of this runs and each hook passes its tensor
through unchanged.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..distributed import spmd as SP
from . import attention as A
from . import layers as L
from . import moe as M
from . import rwkv as R
from . import ssm as SSM

MIXERS = ("attn", "mla", "mamba", "rwkv6", "cross_attn")
MLPS = ("dense", "moe", "rwkv_cmix", "none")


def _check_spec(spec):
    if spec.mixer not in MIXERS:
        raise ValueError(f"mixer {spec.mixer!r}: one of {MIXERS}")
    if spec.mlp not in MLPS:
        raise ValueError(f"mlp {spec.mlp!r}: one of {MLPS}")


def _check_cfg(cfg):
    for specs, _ in cfg.groups:
        for spec in specs:
            _check_spec(spec)


def _check_cond(cfg, cond):
    """A ``cond_dim`` config needs ``cond`` (B, Cs, cond_dim); any other
    takes none."""
    if cfg.cond_dim and cond is None:
        raise ValueError(f"{cfg.name} conditions on (B, Cs, {cfg.cond_dim}) "
                         "features: pass cond=")
    if cond is not None and not cfg.cond_dim:
        raise ValueError(f"{cfg.name} has no conditioning frontend "
                         "(cond_dim 0): cond must be None")


# ----------------------------------------------------------------------
# Trees
# ----------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _items(tree):
    """(key, child) pairs of a dict, list or tuple node."""
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _index(tree, i):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return _tree_map(lambda a: a[i], tree)


def _unstack(tree, count):
    """The ``count`` periods of a stacked tree, each leaf split by one
    ``unbind``. Under autograd its backward stacks the periods' gradients
    once; indexing each period (``_index``) would build a zero-filled
    gradient of the whole stack for every period and sum them."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(count)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, count) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(count)]
    return list(tree.unbind(0))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_stack([t[i] for t in trees])
                              for i in range(len(trees[0])))
    return torch.stack(trees)


def _write(dst, src):
    """Copy each leaf of ``src`` into the same leaf of ``dst`` (views into
    a stacked tree), skipping leaves that already are the destination."""
    for k, v in _items(src):
        if isinstance(v, (dict, list, tuple)):
            _write(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def clone(tree):
    """A deep copy of a tree of tensors (a cache snapshot)."""
    return _tree_map(torch.clone, tree)


def copy_cache(dst, src):
    """Copy cache ``src`` into ``dst`` in place, leaf by leaf: the same
    keys, shapes and dtypes (a server's static cache). Returns ``dst``."""
    for k, d in _items(dst):
        s = src[k]
        if isinstance(d, (dict, list, tuple)):
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
    elif spec.mixer == "mla":
        p["mixer"] = A.mla_init(gen, cfg, device=device)
    elif spec.mixer == "mamba":
        p["mixer"] = SSM.mamba_init(gen, cfg, device=device)
    elif spec.mixer == "rwkv6":
        p["mixer"] = R.rwkv6_init(gen, cfg, device=device)
    else:
        p["mixer"] = A.attn_init(gen, cfg, cross=True, device=device)
        # llama-vision's gate starts at 0: the branch adds nothing until
        # trained
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=device)
    if spec.cross:
        p["norm_c"] = L.rmsnorm_init(d, dt, device=device)
        p["cross"] = A.attn_init(gen, cfg, cross=True, device=device)
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
    """``count`` periods stacked on a leading axis. Each layer's stacked
    leaves are allocated when its first copy is drawn, and every copy is
    written into them as it is drawn, so the peak is the stack plus one
    layer (a full-size model is never held twice). The draws run period
    by period, layer by layer."""
    out = {}
    for i in range(count):
        for j, spec in enumerate(specs):
            layer = init_layer(gen, cfg, spec, device=device)
            if i == 0:
                out[str(j)] = _tree_map(
                    lambda a: torch.empty((count,) + a.shape, dtype=a.dtype,
                                          device=a.device), layer)
            _write(_index(out[str(j)], i), layer)
            del layer
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
        params["lm_head"] = L.dense_init(
            gen, d, cfg.n_codebooks * cfg.vocab_size, dtype=dt, device=device)
    if cfg.cond_dim:
        params["cond_proj"] = L.dense_init(gen, cfg.cond_dim, d, dtype=dt,
                                           device=device)
    for gi, (specs, count) in enumerate(cfg.groups):
        params["groups"][str(gi)] = _init_group(gen, cfg, specs, count,
                                                device=device)
    if cfg.mtp:
        # the reference's multi-token prediction head: one more layer of
        # the last group's first kind behind a projection of
        # [norm(h), norm(embed(next))]
        params["mtp"] = {
            "proj": L.dense_init(gen, 2 * d, d, dtype=dt, device=device),
            "norm_h": L.rmsnorm_init(d, dt, device=device),
            "norm_e": L.rmsnorm_init(d, dt, device=device),
            "layer": init_layer(gen, cfg, cfg.groups[-1][0][0],
                                device=device),
        }
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
    """``mode`` is "train", "prefill" or "decode"; ``spec`` one the entry
    points have checked (``_check_cfg``). Returns (x, new_cache, aux):
    "train" builds no cache and keeps a MoE layer's load-balance loss as
    ``aux`` (None elsewhere, and on a layer without one)."""
    cfg = ctx["cfg"]
    new_cache, aux = {}, None
    window = spec.window or (ctx["window_attn"] if spec.mixer == "attn" else 0)

    # ---- mixer sublayer ----
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if spec.mixer in ("attn", "mla"):
        if mode == "decode":
            fn = A.attn_decode if spec.mixer == "attn" else A.mla_decode
            mix, new_cache["kv"] = fn(lp["mixer"], h, cache["kv"], t, cfg,
                                      window=window)
        else:
            fn = A.attn_forward if spec.mixer == "attn" else A.mla_forward
            mix, kv = fn(lp["mixer"], h, ctx["positions"], cfg,
                         window=window, kernel=ctx["kernel"])
            if mode == "prefill":
                new_cache["kv"] = _prefill_kv_cache(spec, kv, ctx)
    elif spec.mixer == "mamba":
        if mode == "decode":
            mix, st = SSM.mamba_decode(lp["mixer"], h, cache["ssm"], cfg)
        else:
            mix, st = SSM.mamba_forward(lp["mixer"], h, cfg)
        if mode != "train":
            new_cache["ssm"] = st
    elif spec.mixer == "rwkv6":
        prev = cache["rwkv"] if mode == "decode" else None
        mix, (last_x, state) = R.rwkv6_tmix(
            lp["mixer"], h, cfg,
            state=prev["state"] if prev else None,
            x_prev=prev["tshift"] if prev else None)
        if mode != "train":
            new_cache["rwkv"] = {"tshift": last_x, "state": state}
    else:                                           # cross_attn
        if mode == "decode":
            ckv = (cache["cross"]["k"], cache["cross"]["v"])
            new_cache["cross"] = cache["cross"]     # unchanged, not copied
        else:
            ckv = A.cross_kv(lp["mixer"], ctx["cond_x"], cfg)
            if mode == "prefill":
                new_cache["cross"] = {"k": ckv[0], "v": ckv[1]}
        mix = A.cross_attn_forward(lp["mixer"], h, ckv, cfg)
        mix = torch.tanh(lp["gate_attn"]).to(mix.dtype) * mix
    x = x + mix

    # ---- optional conditioning cross-attention sublayer (musicgen) ----
    if spec.cross:
        h = L.rmsnorm(lp["norm_c"], x, cfg.norm_eps)
        if mode == "decode":
            ckv = (cache["cond"]["k"], cache["cond"]["v"])
            new_cache["cond"] = cache["cond"]
        else:
            ckv = A.cross_kv(lp["cross"], ctx["cond_x"], cfg)
            if mode == "prefill":
                new_cache["cond"] = {"k": ckv[0], "v": ckv[1]}
        x = x + A.cross_attn_forward(lp["cross"], h, ckv, cfg)

    # ---- mlp sublayer ----
    if spec.mlp != "none":
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        if spec.mlp == "dense":
            out = L.mlp(lp["mlp"], h, cfg.mlp_act)
        elif spec.mlp == "moe":
            out, moe_aux = _moe(lp["mlp"], h, ctx)
            if mode == "train":
                aux = moe_aux
        else:
            prev = cache["cmix"] if mode == "decode" else None
            out, last_c = R.rwkv6_cmix(lp["mlp"], h, cfg, x_prev=prev)
            if mode != "train":
                new_cache["cmix"] = last_c
        x = x + out
    return x, new_cache, aux


def _moe(p, h, ctx):
    """A MoE sublayer: through ``moe_forward_a2a`` when the ``moe_a2a``
    hook is set; else the dispatch of ``moe_forward`` (after the
    ``moe_pre`` hook). In a sharded step (``ctx["spmd"]``, a region) the
    dispatch runs over every rank's tokens, as GSPMD runs the reference's
    over the global batch, and each rank keeps its own rows."""
    cfg, region = ctx["cfg"], ctx.get("spmd")
    if ctx["moe_a2a"]:
        if region is None:
            return M.moe_forward_a2a(p, h, cfg, **ctx["moe_a2a"])
        y, aux = M.moe_forward_a2a(p, region.wrap(h), cfg, **ctx["moe_a2a"])
        return region.rows(y), aux
    if region is None:
        if ctx["moe_pre"]:
            h = ctx["moe_pre"](h)
        return M.moe_forward(p, h, cfg)
    hd = region.wrap(h)
    if ctx["moe_pre"]:
        hd = ctx["moe_pre"](hd)
    y, aux = M.moe_forward(p, SP.local(hd, region.mesh, (),
                                       partial=region.axes), cfg)
    n, i = h.shape[0], region.index()
    return y[i * n:(i + 1) * n], aux


def _prefill_kv_cache(spec, kv, ctx):
    """The prompt's keys and values (GQA) or latents (MLA) packed into
    the layer's ring buffer."""
    Wc = ctx["cache_len"]
    positions = ctx["positions"]
    positions = positions[0] if positions.dim() == 2 else positions
    names = ("k", "v") if spec.mixer == "attn" else ("ckv", "krope")
    (a, pos), (b, _) = (_pack_ring(full, positions, Wc) for full in kv)
    return {names[0]: a, names[1]: b, "pos": pos}


def apply_period(pp, specs, x, ctx, mode, cache, t):
    """Returns (x, new_cache, aux): the layers' aux losses summed in
    order (None where no layer has one)."""
    new_cache, aux = {}, None
    for i, spec in enumerate(specs):
        lc = cache[str(i)] if cache is not None else None
        x, new_cache[str(i)], a = apply_layer(pp[str(i)], spec, x, ctx, mode,
                                              lc, t)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, new_cache, aux


# ----------------------------------------------------------------------
# Forward passes
# ----------------------------------------------------------------------

def _embed_tokens(params, cfg, tokens):
    """(B, S) tokens, or (B, S, ncb) for a multi-codebook config: the sum
    of each codebook's embedding, in the reference's order."""
    emb = params["embed"]["emb"]                       # (ncb, V, d)
    tokens = tokens.long()
    if cfg.n_codebooks == 1:
        return emb[0][tokens]
    return sum(emb[c][tokens[..., c]] for c in range(cfg.n_codebooks))


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        w = params["embed"]["emb"].reshape(cfg.n_codebooks * cfg.vocab_size,
                                           cfg.d_model)
        out = x @ w.T
    else:
        out = L.dense(params["lm_head"], x)
    if cfg.n_codebooks > 1:
        out = out.reshape(out.shape[:-1] + (cfg.n_codebooks, cfg.vocab_size))
    return out


def _cond_x(params, cfg, cond):
    """The conditioning features in the model's width: ``cond`` cast to
    the weights' dtype, then ``cond_proj``."""
    if cond is None:
        return None
    return L.dense(params["cond_proj"], cond.to(L.pdtype(cfg)))


def _make_ctx(cfg, positions, cond_x=None, *, kernel="jnp", window_attn=0,
              cache_len=0, moe_a2a=None, moe_pre=None):
    return {"cfg": cfg, "positions": positions, "cond_x": cond_x,
            "kernel": kernel, "window_attn": window_attn,
            "cache_len": cache_len, "moe_a2a": moe_a2a, "moe_pre": moe_pre,
            "spmd": None}


# ----------------------------------------------------------------------
# Sharded steps (parameters placed as DTensors by distributed.sharding)
# ----------------------------------------------------------------------

def _sharded(params):
    """A sharded step: the parameters are DTensors (``launch.specs``)."""
    return SP.is_dtensor(params["embed"]["emb"])


def _as_dtensor(x, params):
    """A plain input of a sharded step is whole on every rank."""
    if x is None or SP.is_dtensor(x):
        return x
    mesh = params["embed"]["emb"].device_mesh
    return SP.place(x, mesh, SP.shard_placements(mesh, ()))


def _embed(params, cfg, tokens):
    """``_embed_tokens``; in a sharded step each rank embeds its own rows
    of ``tokens`` with the gathered table."""
    if not _sharded(params):
        return _embed_tokens(params, cfg, tokens)
    tokens = _as_dtensor(tokens, params)
    region = SP.Region.of(tokens)
    emb = {"embed": region.params(params["embed"])}
    return region.wrap(_embed_tokens(emb, cfg, region.rows(tokens)))


def _cond(params, cfg, cond, like):
    """``_cond_x``; sharded, split as the activation ``like``."""
    if cond is None or not _sharded(params):
        return _cond_x(params, cfg, cond)
    region = SP.Region.of(like)
    p = {"cond_proj": region.params(params["cond_proj"])}
    return region.wrap(_cond_x(p, cfg, region.rows(_as_dtensor(cond,
                                                                params))))


def _head(params, cfg, x, *, last=False):
    """Final norm and logits (of the last position only with ``last``);
    sharded, on each rank's rows with the gathered head."""
    if not SP.is_dtensor(x):
        if last:
            x = x[:, -1:, :]
        return _logits(params, cfg, L.rmsnorm(params["final_norm"], x,
                                              cfg.norm_eps))
    region = SP.Region.of(x)
    p = region.params({k: params[k] for k in ("embed", "lm_head",
                                              "final_norm") if k in params})
    xl = region.rows(x)
    if last:
        xl = xl[:, -1:, :]
    return region.wrap(_logits(p, cfg, L.rmsnorm(p["final_norm"], xl,
                                                 cfg.norm_eps)))


def _is_moe_mlp(specs, path):
    return (len(path) == 2 and path[1] == "mlp"
            and specs[int(path[0])].mlp == "moe")


def _period(pp, specs, x, ctx, mode, cache, t):
    """``apply_period``; sharded (``x`` a DTensor), one region: each
    rank runs the period on its rows with the period's weights gathered
    (a MoE layer's weights stay placed for ``moe_forward_a2a`` when the
    hook is set), and a decode cache is read and written in place
    through its local block."""
    if not SP.is_dtensor(x):
        return apply_period(pp, specs, x, ctx, mode, cache, t)
    region = SP.Region.of(x)
    a2a = ctx["moe_a2a"] is not None
    lp = region.params(pp, lambda path: a2a and _is_moe_mlp(specs, path))
    xl = region.rows(x)
    lctx = dict(ctx, spmd=region)
    if ctx["positions"] is not None and ctx["positions"].dim() == 2:
        lctx["positions"] = ctx["positions"][:xl.shape[0]]
    if ctx["cond_x"] is not None:
        lctx["cond_x"] = region.rows(ctx["cond_x"])
    lc = None if cache is None else _cache_rows(region, cache)
    xo, nc, aux = apply_period(lp, specs, xl, lctx, mode, lc, t)
    if cache is not None:
        _cache_write(region, cache, nc)
    return region.wrap(xo), nc, aux


def _cache_rows(region, cache):
    """Each rank's block of a placed cache (views where the placement is
    already the region's)."""
    if isinstance(cache, dict):
        return {k: (SP.local(v, region.mesh, ()) if k == "pos"
                    else _cache_rows(region, v)) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_cache_rows(region, v) for v in cache)
    return region.rows(cache)


@torch.no_grad()
def _cache_write(region, dst, src):
    """A decode step's local cache back into the placed cache ``dst``
    (nothing to do where the step wrote the DTensor's own block)."""
    for k, d in _items(dst):
        v = src[k]
        if isinstance(d, (dict, list, tuple)):
            _cache_write(region, d, v)
            continue
        block = d.to_local()
        if v.data_ptr() == block.data_ptr() and v.shape == block.shape:
            continue
        new = (SP.place(v, region.mesh, d.placements) if k == "pos"
               else region.wrap(v).redistribute(region.mesh, d.placements))
        block.copy_(new.to_local())


def _wrap_cache(region, cache):
    """A prefill's stacked local caches as DTensors: batch rows (dim 1,
    after the stack) split as the region's, ``pos`` replicated."""
    if isinstance(cache, dict):
        return {k: (SP.place(v, region.mesh, SP.shard_placements(
                    region.mesh, ())) if k == "pos"
                    else _wrap_cache(region, v)) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_wrap_cache(region, v) for v in cache)
    return region.wrap(cache, dim=1)


def forward_train(params, cfg, tokens, *, cond=None, next_tokens=None,
                  kernel="jnp", constrain=None, moe_a2a=None):
    """The whole sequence (B, S), or (B, S, ncb), in "train" mode.
    Returns (logits (B, S, V) or (B, S, ncb, V), {"moe_aux": 0-d float32,
    "mtp_logits": as logits, for an ``mtp`` config given
    ``next_tokens``}). ``cond``: the conditioning features (B, Cs,
    cond_dim) a ``cond_dim`` config needs."""
    _check_cfg(cfg)
    _check_cond(cfg, cond)
    B, Sq = tokens.shape[0], tokens.shape[1]
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=tokens.device).expand(B, Sq)
    x = _embed(params, cfg, tokens)
    if constrain:
        x = constrain(x)
    ctx = _make_ctx(cfg, positions, _cond(params, cfg, cond, x),
                    kernel=kernel, moe_a2a=moe_a2a)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    for gi, (specs, count) in enumerate(cfg.groups):
        def body(x, pp, specs=specs):
            x, _, a = _period(pp, specs, x, ctx, "train", None, None)
            if constrain:
                x = constrain(x)
            return x, a

        for pp in _unstack(params["groups"][str(gi)], count):
            if cfg.remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    body, x, pp, use_reentrant=False)
            else:
                x, a = body(x, pp)
            if a is not None:
                aux = aux + a

    extras = {"moe_aux": aux}
    logits = _head(params, cfg, x)

    if cfg.mtp and next_tokens is not None:
        mp = params["mtp"]
        e = _embed(params, cfg, next_tokens)
        spec = cfg.groups[-1][0][0]

        def mtp(mp, h, e, ctx):
            hcat = torch.cat([L.rmsnorm(mp["norm_h"], h, cfg.norm_eps),
                              L.rmsnorm(mp["norm_e"], e, cfg.norm_eps)],
                             dim=-1)
            h2 = L.dense(mp["proj"], hcat)
            return apply_layer(mp["layer"], spec, h2, ctx, "train", None,
                               None)

        if SP.is_dtensor(x):
            # one region: the head's layer on each rank's rows
            region = SP.Region.of(x)
            a2a = moe_a2a is not None
            lmp = region.params(mp, lambda path: a2a and path == (
                "layer", "mlp") and spec.mlp == "moe")
            el = region.rows(e)
            lctx = dict(ctx, spmd=region,
                        positions=positions[:el.shape[0]])
            if ctx["cond_x"] is not None:
                lctx["cond_x"] = region.rows(ctx["cond_x"])
            h2, _, a2 = mtp(lmp, region.rows(x), el, lctx)
            h2 = region.wrap(h2)
        else:
            h2, _, a2 = mtp(mp, x, e, ctx)
        if a2 is not None:
            extras["moe_aux"] = extras["moe_aux"] + a2
        extras["mtp_logits"] = _head(params, cfg, h2)
    return logits, extras


def prefill(params, cfg, tokens, *, cond=None, cache_len=None,
            window_attn=0, kernel="jnp", constrain=None, moe_a2a=None):
    """Process a full prompt (B, S), or (B, S, ncb); returns
    (last_token_logits (B, 1, V) or (B, 1, ncb, V), cache). ``cond``: the
    conditioning features (B, Cs, cond_dim) a ``cond_dim`` config needs.
    ``kernel``: "jnp" (plain attention) or "pallas" (the flash kernel).
    ``constrain``/``moe_a2a``: the sharding hooks, as in
    ``forward_train``; with placed parameters the cache comes back as
    DTensors split by batch (``pos`` replicated)."""
    _check_cfg(cfg)
    _check_cond(cfg, cond)
    B, Sq = tokens.shape[0], tokens.shape[1]
    if cache_len is None:
        cache_len = Sq
    positions = torch.arange(Sq, dtype=torch.int32,
                             device=tokens.device).expand(B, Sq)
    x = _embed(params, cfg, tokens)
    if constrain:
        x = constrain(x)
    ctx = _make_ctx(cfg, positions, _cond(params, cfg, cond, x),
                    kernel=kernel, window_attn=window_attn,
                    cache_len=cache_len, moe_a2a=moe_a2a)
    caches = {}
    for gi, (specs, count) in enumerate(cfg.groups):
        gp = params["groups"][str(gi)]
        layer_caches = []
        for i in range(count):
            region = SP.Region.of(x) if SP.is_dtensor(x) else None
            x, nc, _ = _period(_index(gp, i), specs, x, ctx, "prefill",
                               None, None)
            if constrain:
                x = constrain(x)
            layer_caches.append(nc)
        caches[str(gi)] = _stack(layer_caches)
        if region is not None:
            caches[str(gi)] = _wrap_cache(region, caches[str(gi)])
    return _head(params, cfg, x, last=True), caches


def decode_step(params, cfg, tokens, cache, t, *, window_attn=0,
                moe_pre=None):
    """One-token decode. tokens: (B, 1), or (B, 1, ncb); t: the position
    (int or 0-d tensor). Writes the step into ``cache`` in place (the
    cross and cond leaves are read, never written); returns (logits
    (B, 1, V) or (B, 1, ncb, V), cache). ``moe_pre``: a callable applied to
    each MoE layer's input before its dispatch (the reference's hook).
    With placed parameters ``tokens`` and ``cache`` are DTensors
    (``launch.specs``): each rank decodes its rows, and the cache is
    written through its local blocks."""
    _check_cfg(cfg)
    x = _embed(params, cfg, tokens)
    t = A.position_tensor(t, x.device)
    ctx = _make_ctx(cfg, None, window_attn=window_attn, moe_pre=moe_pre)
    for gi, (specs, count) in enumerate(cfg.groups):
        gp, gc = params["groups"][str(gi)], cache[str(gi)]
        for i in range(count):
            lc = _index(gc, i)
            sharded = SP.is_dtensor(x)
            x, nc, _ = _period(_index(gp, i), specs, x, ctx, "decode", lc,
                               t)
            if not sharded:
                _write(lc, nc)
    return _head(params, cfg, x), cache


# ----------------------------------------------------------------------
# Cache init
# ----------------------------------------------------------------------

def init_layer_cache(cfg, spec, batch, cache_len, dtype, *, device):
    _check_spec(spec)
    c = {}
    if spec.mixer == "attn":
        c["kv"] = A.attn_cache_init(cfg, batch, cache_len, dtype, device=device)
    elif spec.mixer == "mla":
        c["kv"] = A.mla_cache_init(cfg, batch, cache_len, dtype, device=device)
    elif spec.mixer == "mamba":
        c["ssm"] = SSM.mamba_cache_init(cfg, batch, dtype, device=device)
    elif spec.mixer == "rwkv6":
        c["rwkv"] = R.rwkv6_cache_init(cfg, batch, dtype, device=device)
    else:
        c["cross"] = A.cross_cache_init(cfg, batch, dtype, device=device)
    if spec.cross:
        c["cond"] = A.cross_cache_init(cfg, batch, dtype, device=device)
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
