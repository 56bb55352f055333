"""Mamba-1 selective-SSM block (Jamba's recurrent mixer).

The port of ``repro/models/ssm.py``. The reference runs the selective
scan as a ``lax.scan`` over time with the discretization (dA, dBx)
computed inside the body; the port loops over the sequence in Python,
one step a token, so only the (B, d_inner, d_state) state lives across
steps here too. The scan is no Pallas kernel in the reference, so it is
plain PyTorch here. Decode is a single recurrence step against a
``(conv_state, ssm_state)`` cache, a tuple as in the reference.

Cast points follow the reference exactly: the scan carries a float32
state; ``xc`` (the convolved input), ``dt``, ``B`` and ``C`` go up to
float32 before it; ``A_log``, ``D`` and ``dt_bias`` are float32 leaves
even in a bf16 model; ``y`` comes back to the input's dtype before
``out_proj``.

Decode writes its state IN PLACE: ``conv_state`` shifts by one token
and the state takes the new value with ``copy_``, so the server's
decode step runs as a CUDA graph over a static cache
(``serving/engine.py``). The reference returns new arrays; callers that
keep a cache (the server's prefix cache) store a copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..analysis.hlo_analyzer import scan_steps, stack_steps
from . import layers as L


def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


def mamba_init(gen, cfg, *, device):
    d = cfg.d_model
    m = cfg.mamba
    di, st, dc = m.d_inner(d), m.d_state, m.d_conv
    dtr = dt_rank(cfg)
    dt = L.pdtype(cfg)
    # S4D-real initialization for A
    A = torch.arange(1, st + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": L.dense_init(gen, d, 2 * di, dtype=dt, device=device),
        "conv_w": L.normal(gen, (dc, di), 1.0 / math.sqrt(dc), dtype=dt,
                           device=device),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": L.dense_init(gen, di, dtr + 2 * st, dtype=dt, device=device),
        "dt_w": L.dense_init(gen, dtr, di, dtype=dt, device=device),
        # softplus^-1(1)
        "dt_bias": torch.full((di,), math.log(math.e - 1), dtype=torch.float32,
                              device=device),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.dense_init(gen, di, d, dtype=dt, device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(p, x, cfg):
    """Depthwise causal conv. x: (B, S, di) -> (B, S, di), summed tap by
    tap in the input's dtype, as the reference's ``sum``."""
    dc = cfg.mamba.d_conv
    S = x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = pad[:, :S] * p["conv_w"][0]
    for i in range(1, dc):
        out = out + pad[:, i:i + S] * p["conv_w"][i]
    return out + p["conv_b"]


def _ssm_step(A, h, x_t, dt_t, b_t, c_t):
    """One recurrence step, float32: x_t, dt_t (B, di); b_t, c_t (B, st);
    h (B, di, st). Returns (h, y (B, di))."""
    dA = torch.exp(dt_t[..., None] * A)                       # (B, di, st)
    dBx = (dt_t * x_t)[..., None] * b_t[:, None, :]           # (B, di, st)
    h = dA * h + dBx
    return h, torch.einsum("bds,bs->bd", h, c_t)


def _ssm_scan(p, xr, dt_, B_, C_, h0):
    """Selective scan, a Python step a token. xr/dt_: (B, S, di); B_/C_:
    (B, S, st); h0: (B, di, st). Returns (h, ys (B, S, di))."""
    A = -torch.exp(p["A_log"])                                # (di, st)
    xr = xr.float()
    S = xr.shape[1]
    h, ys = h0, []
    for t in scan_steps(S, xr):
        h, y = _ssm_step(A, h, xr[:, t], dt_[:, t], B_[:, t], C_[:, t])
        ys.append(y)
    return h, stack_steps(ys, S)


def _projections(p, xc, cfg):
    st = cfg.mamba.d_state
    dtr = dt_rank(cfg)
    proj = L.dense(p["x_proj"], xc)
    dt_in, B_, C_ = proj[..., :dtr], proj[..., dtr:dtr + st], proj[..., dtr + st:]
    dt_ = _softplus(L.dense(p["dt_w"], dt_in).float() + p["dt_bias"])
    return dt_, B_.float(), C_.float()


def _gate(p, y, xc, z, dtype):
    """``(y + D xc) * silu(z)`` in float32, back to ``dtype``."""
    y = y + p["D"] * xc.float()
    return (y * F.silu(z.float())).to(dtype)


def mamba_forward(p, x, cfg):
    """Prefill. x: (B, S, d). Returns (out, (conv_state, ssm_state))."""
    B, S, _ = x.shape
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    xz = L.dense(p["in_proj"], x)
    conv_in, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_causal_conv(p, conv_in, cfg))
    dt_, B_, C_ = _projections(p, xc, cfg)
    h0 = torch.zeros((B, di, m.d_state), dtype=torch.float32, device=x.device)
    h, ys = _ssm_scan(p, xc, dt_, B_, C_, h0)
    out = L.dense(p["out_proj"], _gate(p, ys, xc, z, x.dtype))
    # cache: the last (d_conv - 1) pre-conv inputs + the final ssm state
    keep = m.d_conv - 1
    conv_state = (conv_in[:, S - keep:, :] if S >= keep
                  else F.pad(conv_in, (0, 0, keep - S, 0)))
    return out, (conv_state, h)


def mamba_decode(p, x, cache, cfg):
    """One-token decode. x: (B, 1, d); cache: (conv_state, ssm_state),
    written in place. Returns (out, cache)."""
    conv_state, h = cache
    di = cfg.mamba.d_inner(cfg.d_model)
    xz = L.dense(p["in_proj"], x)
    xr, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv_state, xr.to(conv_state.dtype)], dim=1)  # (B, dc, di)
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)[:, None, :]                                # (B, 1, di)
    dt_, B_, C_ = _projections(p, xc, cfg)
    A = -torch.exp(p["A_log"])
    h_new, y = _ssm_step(A, h, xc[:, 0].float(), dt_[:, 0], B_[:, 0], C_[:, 0])
    out = L.dense(p["out_proj"], _gate(p, y, xc[:, 0], z[:, 0], x.dtype))
    conv_state.copy_(window[:, 1:, :])
    h.copy_(h_new)
    return out[:, None, :], (conv_state, h)


def mamba_cache_init(cfg, batch, dtype, *, device):
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    return (torch.zeros((batch, m.d_conv - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                        device=device))
