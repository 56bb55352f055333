"""Mixture-of-Experts FFN with sort-based, static-capacity dispatch.

The port of ``repro/models/moe.py``: tokens are routed top-k, flattened,
sorted by expert id (stable), scattered into a fixed ``(E, C, d)``
dispatch buffer (capacity ``C = ceil(N*k/E * capacity_factor)`` rounded
up to a multiple of 8; overflow tokens are dropped, the GShard/Switch
discipline), batch-multiplied against the stacked expert weights and
combined back with the router weights. DeepSeek-style shared experts are
a dense SwiGLU MLP added to every token; the Switch load-balance loss
``E * sum_e f_e * p_e`` is returned beside the output.

Every shape is static and nothing reads a value back to the host (no
``.item()``, ``nonzero``, boolean-mask indexing, ``bincount`` or
``unique``), so the dispatch runs inside the server's captured decode
step (``graphs.Graphed``). Where PyTorch differs from ``jax.numpy``:

- Top-k ties: ``jax.lax.top_k`` puts the lower index first, and
  ``torch.topk`` promises no order on ties, so the top k are the first k
  of a stable descending sort (a zero router is all ties).
- ``mode="drop"``: the reference drops the writes whose slot is past
  the capacity. Here they land in an extra row ``C`` of an
  ``(E, C + 1, d)`` buffer that is then cut off; clamping the slot
  instead would overwrite a kept token.
- The combine sums each token's k weighted expert outputs in float32 in
  a fixed order (a gather through the inverse of the sort), where the
  reference scatter-adds them: ``index_add_`` on the card adds with
  atomics in an order that changes between runs, and one flipped last
  bit can move the bf16 rounding of a token's output, so a graphed
  replay would no longer equal an eager run bit for bit.

Router logits, the softmax and the combine are float32; the expert
products stay in the weights' dtype, as in the reference. They are
``torch.bmm``: the reference leaves them to XLA outside any Pallas
kernel. ``moe_forward_a2a`` (expert parallelism over a mesh) is ROADMAP
item 12's and raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L


def moe_init(gen: torch.Generator, cfg, *, device):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = L.pdtype(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {
        # the router stays float32 for a stable top-k
        "router": L.normal(gen, (d, E), scale, device=device),
        "gate": L.normal(gen, (E, d, ff), scale, dtype=dt, device=device),
        "up": L.normal(gen, (E, d, ff), scale, dtype=dt, device=device),
        "down": L.normal(gen, (E, ff, d), 1.0 / math.sqrt(ff), dtype=dt,
                         device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.n_shared_experts, "swiglu",
                                 dtype=dt, device=device)
    return p


def capacity(n_tokens: int, cfg) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_tok / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def route(router, xf, k):
    """(probs (N, E), top_w (N, k) renormalised, top_i (N, k)), all from
    float32 logits; ties keep the lower expert first, as
    ``jax.lax.top_k``."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_i


def dispatch(top_i, C, E):
    """The sort-based dispatch of N*k (token, expert) picks: ``order``
    (the stable sort by expert), and per sorted pick its expert ``se``,
    token ``st``, slot ``pos`` in that expert's buffer and ``keep``
    (``pos < C``)."""
    Nk = top_i.numel()
    k = top_i.shape[-1]
    dev = top_i.device
    eids = top_i.reshape(Nk)
    order = torch.sort(eids, stable=True).indices
    se = eids[order]
    st = order // k
    starts = torch.searchsorted(se, torch.arange(E, dtype=se.dtype, device=dev))
    pos = torch.arange(Nk, device=dev) - starts[se]
    return order, se, st, pos, pos < C


def moe_forward(p, x, cfg):
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    N = B * S
    xf = x.reshape(N, d)
    probs, top_w, top_i = route(p["router"], xf, k)

    # ---- aux load-balance loss (Switch): E * sum_e f_e * p_e ----
    flat = top_i.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=x.device))
    f = counts / (N * k)
    aux = E * torch.sum(f * probs.mean(dim=0))

    # ---- sort-based dispatch; writes past the capacity land in row C ----
    C = capacity(N, cfg)
    order, se, st, pos, keep = dispatch(top_i, C, E)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((se, torch.where(keep, pos, C)), xf[st])[:, :C]

    h = F.silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    out_buf = torch.bmm(h, p["down"])                          # (E, C, d)

    sw = top_w.reshape(-1)[order]
    contrib = out_buf[se, pos.clamp_max(C - 1)] * (sw * keep)[:, None]
    # back to (token, pick) order; the k picks of a token summed in order
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    y = contrib.float()[inv].reshape(N, k, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], x, "swiglu")
    return y, aux


def moe_forward_a2a(p, x, cfg, **kw):
    raise NotImplementedError(
        "moe_forward_a2a (expert parallelism with all-to-all dispatch over "
        "a mesh) is not ported yet (ROADMAP item 12)")


def moe_ref(p, x, cfg):
    """O(N*E) dense oracle (every expert applied to every token, masked).

    Used only in tests to validate the dispatch path on small shapes.
    """
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    _, top_w, top_i = route(p["router"], xf, cfg.experts_per_tok)
    gate_w = torch.zeros((N, cfg.n_experts), dtype=torch.float32,
                         device=x.device).scatter(1, top_i, top_w)
    h = F.silu(torch.einsum("nd,edf->nef", xf, p["gate"])) \
        * torch.einsum("nd,edf->nef", xf, p["up"])
    o = torch.einsum("nef,efd->ned", h, p["down"])
    y = torch.einsum("ned,ne->nd", o.float(), gate_w)
    y = y.to(x.dtype).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], x, "swiglu")
    return y
