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
kernel. ``moe_forward_a2a`` is the expert-parallel form over a
``DeviceMesh``: each rank dispatches its own tokens and exchanges them
with its expert group through ``all_to_all_single``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..training.tree import tree_map
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
    y = _combine(contrib, order, N, k).to(x.dtype).reshape(B, S, d)

    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], x, "swiglu")
    return y, aux


def _combine(contrib, order, N, k):
    """Each token's k weighted picks summed in float32 in a fixed order
    (a gather through the inverse of the sort; see the module note)."""
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return contrib.float()[inv].reshape(N, k, -1).sum(dim=1)


def moe_forward_a2a(p, x, cfg, *, mesh, token_axes, expert_axes,
                    pair_capacity_factor=2.0):
    """Expert-parallel MoE with an explicit all-to-all dispatch: the
    reference's shard_map body run on each rank of ``mesh`` (a
    ``DeviceMesh`` with the reference's axis names).

    Each rank routes its local tokens, exchanges exactly
    ``(n_dev, C_pair, d)`` with its expert-parallel group, runs its local
    experts, and reverses the exchange.

    token_axes: mesh axes sharding the flattened token dim of x.
    expert_axes: mesh axes the expert dim is sharded over: a suffix of
                token_axes; the all-to-all runs over them, the outer
                axes form independent groups.
    Tokens overflowing per-pair or per-expert capacity are dropped
    (the dispatch path's capacity discipline). The load-balance loss
    averages the expert counts and mean probabilities over the expert
    group, then the loss over the token axes (``pmean``); where x is not
    split over a token axis, the ranks along it hold the same rows and
    their copies of the loss share its gradient.

    ``x`` (B, S, d) and the leaves of ``p`` are DTensors on ``mesh`` or
    plain tensors holding the whole value on every rank. The tokens are
    split over ``token_axes``, the expert stacks over ``expert_axes``,
    the router and shared experts gathered whole. Returns (y, aux): y a
    DTensor placed as x when x is one, else the whole plain output; aux
    a plain 0-d float32, the same on every rank. Both
    exchanges are differentiable (the backward is the reverse exchange).
    """
    from torch.distributed.tensor import Shard

    from ..distributed import spmd as SP
    token_axes, expert_axes = tuple(token_axes), tuple(expert_axes)
    if (not expert_axes or len(expert_axes) > len(token_axes)
            or token_axes[len(token_axes) - len(expert_axes):] != expert_axes):
        raise ValueError(f"expert_axes {expert_axes} must be a suffix of "
                         f"token_axes {token_axes}")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    n_dev = SP.axes_size(mesh, expert_axes)
    if E % n_dev:
        raise ValueError(f"{E} experts do not split over {n_dev} ranks")
    outer = token_axes[:len(token_axes) - len(expert_axes)]

    xf = SP.local(x.reshape(B * S, d), mesh, token_axes)
    router = SP.local(p["router"], mesh, (), partial=token_axes)
    gate, up, down = (SP.local(p[n], mesh, expert_axes, partial=outer)
                      for n in ("gate", "up", "down"))

    N_loc = xf.shape[0]
    E_loc = gate.shape[0]
    dev = xf.device
    probs, top_w, top_i = route(router, xf, k)

    flat = top_i.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32, device=dev)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                          device=dev))
    f = SP.all_reduce_mean(counts / (N_loc * k), mesh, expert_axes)
    pbar = SP.all_reduce_mean(probs.mean(dim=0), mesh, expert_axes)
    aux = E * torch.sum(f * pbar)

    # first level: picks sorted by expert, bucketed by destination rank
    Nk = N_loc * k
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    st = order // k
    sw = top_w.reshape(-1)[order]
    dest = torch.div(se, E_loc, rounding_mode="floor")
    starts = torch.searchsorted(
        se, torch.arange(0, E, E_loc, dtype=se.dtype, device=dev))
    pos = torch.arange(Nk, device=dev) - starts[dest]
    Cp = max(8, -(-math.ceil(Nk / n_dev * pair_capacity_factor) // 8) * 8)
    keep = pos < Cp
    slot = torch.where(keep, pos, Cp)            # row Cp: dropped, cut off
    send_x = torch.zeros((n_dev, Cp + 1, d), dtype=x.dtype, device=dev)
    send_x = send_x.index_put((dest, slot), xf[st])[:, :Cp]
    # local expert id at the destination; -1 = empty slot
    send_e = torch.full((n_dev, Cp + 1), -1, dtype=torch.int64, device=dev)
    send_e = send_e.index_put((dest, slot), se % E_loc)[:, :Cp]

    rx = SP.all_to_all(send_x, mesh, expert_axes).reshape(n_dev * Cp, d)
    re_ = SP.all_to_all(send_e, mesh, expert_axes).reshape(n_dev * Cp)

    # second level: the received rows into the E_loc local experts
    keys = torch.where(re_ < 0, E_loc, re_)       # empties sort last
    order2 = torch.sort(keys, stable=True).indices
    se2k = keys[order2]
    C2 = n_dev * Cp
    starts2 = torch.searchsorted(
        se2k, torch.arange(E_loc, dtype=se2k.dtype, device=dev))
    eid2 = se2k.clamp(0, E_loc - 1)
    pos2 = torch.arange(C2, device=dev) - starts2[eid2]
    valid2 = se2k < E_loc
    buf = torch.zeros((E_loc, C2 + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((eid2, torch.where(valid2, pos2, C2)),
                        rx[order2])[:, :C2]

    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    out_buf = torch.bmm(h, down)                  # (E_loc, C2, d)

    # undo the second-level permutation, then the exchange
    vals = out_buf[eid2, pos2.clamp_max(C2 - 1)] * valid2[:, None]
    inv2 = torch.empty_like(order2).scatter_(
        0, order2, torch.arange(C2, device=dev))
    back = vals[inv2].reshape(n_dev, Cp, d)
    ret = SP.all_to_all(back, mesh, expert_axes)

    contrib = ret[dest, pos.clamp_max(Cp - 1)] * (sw * keep)[:, None]
    y = _combine(contrib, order, N_loc, k).to(x.dtype)
    aux = SP.all_reduce_mean(aux, mesh, token_axes)   # fully replicated
    # the ranks of a token axis that x is not split over compute their
    # loss from the same rows, so each uses this aux once for all of them
    split = () if not SP.is_dtensor(x) else tuple(
        a for a, pl in zip(SP.mesh_names(mesh), x.placements)
        if isinstance(pl, Shard) and pl.dim == 0)
    aux = SP.scale_grad(aux, 1 / SP.axes_size(
        mesh, tuple(a for a in token_axes if a not in split)))

    if p.get("shared") is not None:
        shared = tree_map(lambda w: SP.local(w, mesh, (),
                                             partial=token_axes), p["shared"])
        y = y + L.mlp(shared, xf, "swiglu")
    from torch.distributed.tensor import DTensor
    y = DTensor.from_local(y, mesh, SP.shard_placements(mesh, token_axes),
                           run_check=False)
    if B % SP.axes_size(mesh, token_axes):
        # the token split does not fall on rows of x: gather it first
        y = y.redistribute(mesh, SP.shard_placements(mesh, ()))
    y = y.reshape(B, S, d)
    if not SP.is_dtensor(x):
        return y.full_tensor(), aux
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(mesh, x.placements)
    return y, aux


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
