"""Primitive layers of EMSNet: dense, layernorm, embedding, and their
initialisers.

Parameters are plain dicts of tensors with the JAX package's keys and
layouts (dense weights ``(d_in, d_out)``), so converted reference
weights drop in unchanged. Initialisers draw on the CPU from an explicit
``torch.Generator`` and then move to ``device``, so one seed gives the
same weights on every device.
"""
from __future__ import annotations

import math

import torch

from ..kernels.ops import quantized_matmul


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None, device):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"w": (torch.randn((d_in, d_out), generator=gen) * scale).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
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
    return {"emb": (torch.randn((vocab, d), generator=gen) * 0.02).to(device)}


def embed(p, tokens):
    return p["emb"][tokens.long()]
