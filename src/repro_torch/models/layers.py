"""Primitive layers: dense, norms, RoPE, MLPs, embeddings, and their
initialisers.

Parameters are plain dicts of tensors with the JAX package's keys and
layouts (dense weights ``(d_in, d_out)``), so converted reference
weights drop in unchanged. Weights are stored in ``cfg.dtype`` (bf16
for the full-size LLM configs, float32 for EMSNet and the reduced
variants); norms, softmax and RoPE compute in float32.

Initialisers draw from an explicit ``torch.Generator`` on the
generator's own device, then move to ``device`` in the weight dtype. A
CPU generator gives the same weights on every device; a generator on
the card draws a full-size model there in seconds (its numbers differ
from a CPU generator's of the same seed).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..kernels.ops import quantized_matmul


def pdtype(cfg) -> torch.dtype:
    """The weight dtype a config names (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, scale: float, *, dtype=torch.float32,
           device):
    """``N(0, 1) * scale`` drawn in float32 on the generator's device, then
    cast to ``dtype`` on ``device`` (the reference's ``(normal * s).astype``)."""
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               dtype=torch.float32, device):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"w": normal(gen, (d_in, d_out), scale, dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    if "w_q" in p:
        # int8 sidecar form (models.quantized.quantize_dense_params):
        # per-output-channel int8 weights + float32 scales. Activations
        # are rowwise-quantized on the fly and the contraction runs
        # through the fused int8 x int8 -> int32 -> scaled float32 GEMM.
        y = quantized_matmul(x, p["w_q"], p["w_scale"]).to(x.dtype)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.float32, *, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, *, device):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int, *, device):
    return {"emb": normal(gen, (vocab, d), 0.02, device=device)}


def embed(p, tokens):
    return p["emb"][tokens.long()]


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    """Inverse frequencies, the reference's numpy float32 expression, so
    they are bit-equal to its."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int.

    Rotates interleaved lane pairs ``(x[..., 0::2], x[..., 1::2])`` and
    stacks them back, as the reference does (not the half-split
    ``rotate_half`` form)."""
    inv = _inv_freq(x.shape[-1], float(theta), x.device)     # (D/2,)
    ang = positions[..., None].float() * inv                  # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:          # (..., S, H, D): broadcast over H
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, ff: int, act: str, *,
             dtype=torch.float32, device):
    if act == "swiglu":
        return {"gate": dense_init(gen, d, ff, dtype=dtype, device=device),
                "up": dense_init(gen, d, ff, dtype=dtype, device=device),
                "down": dense_init(gen, ff, d, dtype=dtype, device=device)}
    if act == "relu2":
        return {"up": dense_init(gen, d, ff, dtype=dtype, device=device),
                "down": dense_init(gen, ff, d, dtype=dtype, device=device)}
    raise ValueError(act)


def mlp(p, x, act: str):
    if act == "swiglu":
        h = torch.nn.functional.silu(dense(p["gate"], x)) * dense(p["up"], x)
    elif act == "relu2":
        h = torch.square(torch.relu(dense(p["up"], x)))
    else:
        raise ValueError(act)
    return dense(p["down"], h)
