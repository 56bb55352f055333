"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The time-mix recurrence per head (head dim n):
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t          (S: n x n state)
    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora(x_t))). Prefill runs the recurrence over
the prompt, decode one step of it, both through ``kernels.ops.
rwkv6_scan``: the hand-written CUDA kernel on the card, its plain
version on the CPU. The constant-size state is the arch's decode cache.

Cast points follow the reference exactly: the token-shift mix is
computed in float32 and cast back to the weight dtype before each
product; ``w0``, ``u`` and ``ln_x`` are float32 leaves even in a bf16
model; the decay is computed in float32; ``ln_x`` is a population-
variance layernorm over each head's lanes; ``y * g`` is computed in
float32, cast, then goes through ``wo``. r, k and v reach the scan in
the weight dtype: its kernel up-casts them exactly as it loads them,
where the reference casts them first, so no cast kernel runs per layer.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from . import layers as L


def rwkv6_init(gen, cfg, *, device):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    dt = L.pdtype(cfg)
    scale = 1.0 / math.sqrt(d)

    def mat(a, b, s=scale):
        return L.normal(gen, (a, b), s, dtype=dt, device=device)

    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=device),  # shift mix for r,k,v,w,g
        "wr": mat(d, d), "wk": mat(d, d), "wv": mat(d, d), "wg": mat(d, d),
        "wo": mat(d, d),
        # decay init spread across channels (v6 style)
        "w0": torch.linspace(-6.0, -1.0, d, dtype=torch.float32, device=device),
        "w_lora_a": mat(d, 64, 0.01),
        "w_lora_b": mat(64, d, 0.01),
        "u": L.normal(gen, (H, hd), 0.1, device=device),
        "ln_x": L.layernorm_init(hd, device=device),    # per-head group norm
    }


def _tmix_projections(p, x, x_prev, cfg):
    """x: (B, S, d); x_prev: the previous token's x (token shift)."""
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    B, S, _ = x.shape
    mu = p["mu"].float()
    xf, xpf = x.float(), x_prev.float()

    def mix(i):
        return (xf + (xpf - xf) * mu[i]).to(x.dtype)

    r = (mix(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mix(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (mix(2) @ p["wv"]).reshape(B, S, H, hd)
    wx = mix(3)
    lora = torch.tanh(wx @ p["w_lora_a"].to(wx.dtype)) @ p["w_lora_b"].to(wx.dtype)
    w = torch.exp(-torch.exp(p["w0"] + lora.float()))          # (B,S,d) in (0,1)
    w = w.reshape(B, S, H, hd)
    g = torch.nn.functional.silu(mix(4) @ p["wg"]).reshape(B, S, H, hd)
    return r, k, v, w, g


def _wkv_scan(r, k, v, w, u, S0):
    """The recurrence. r/k/v: (B, S, H, n) in the model's dtype (the
    kernel up-casts them exactly as it loads them, as the reference's
    ``astype(float32)`` does); w: (B, S, H, n) float32; u: (H, n); S0:
    (B, H, n, n) or None (zeros). Returns (state, y), the reference's
    order; the kernel's wrapper returns (y, state)."""
    y, state = kops.rwkv6_scan(r, k, v, w, u, S0)
    return state, y


def rwkv6_tmix(p, x, cfg, *, state=None, x_prev=None):
    """Time-mix. Returns (out, (last_x, state))."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    shifted = torch.cat([x_prev, x[:, :-1, :]], dim=1)
    r, k, v, w, g = _tmix_projections(p, x, shifted, cfg)
    state, y = _wkv_scan(r.contiguous(), k.contiguous(), v.contiguous(), w,
                         p["u"], state)
    y = L.layernorm(p["ln_x"], y)                               # per-head norm
    y = (y * g.float()).reshape(B, S, d).to(x.dtype)
    out = y @ p["wo"]
    return out, (x[:, -1:, :], state)


def cmix_init(gen, cfg, *, device):
    d, ff = cfg.d_model, cfg.d_ff
    dt = L.pdtype(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "mu": torch.full((2, d), 0.5, dtype=dt, device=device),
        "wk": L.normal(gen, (d, ff), s, dtype=dt, device=device),
        "wv": L.normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype=dt, device=device),
        "wr": L.normal(gen, (d, d), s, dtype=dt, device=device),
    }


def rwkv6_cmix(p, x, cfg, *, x_prev=None):
    """Channel-mix: sigmoid(xr @ wr) * (relu(xk @ wk)^2 @ wv). Returns
    (out, last_x)."""
    B, S, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    shifted = torch.cat([x_prev, x[:, :-1, :]], dim=1)
    mu = p["mu"].float()
    xf, xpf = x.float(), shifted.float()
    xk = (xf + (xpf - xf) * mu[0]).to(x.dtype)
    xr = (xf + (xpf - xf) * mu[1]).to(x.dtype)
    kv = torch.square(torch.relu(xk @ p["wk"])) @ p["wv"]
    out = torch.sigmoid(xr @ p["wr"]) * kv
    return out, x[:, -1:, :]


def rwkv6_cache_init(cfg, batch, dtype, *, device):
    """The time-mix's decode cache. (The reference also builds a
    ``cshift`` entry that nothing reads: the channel-mix's shift row is
    the layer cache's ``cmix`` entry, ``transformer.init_layer_cache``.)"""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    return {
        "tshift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
    }
