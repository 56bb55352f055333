"""Optimizers as pure transforms of trees of tensors: AdamW, Adafactor
and SGD.

The port of ``repro.training.optimizer``. An update takes
``(grads, state, params)`` and returns ``(new_params, new_state,
grad_norm)`` without touching its arguments. State trees have the
reference's keys and shapes (AdamW ``{"m", "v", "step"}``, Adafactor
``{"v", "step"}`` with ``{"vr", "vc"}`` or ``{"v"}`` per leaf, SGD
``{"step"}``), so a checkpoint of the state has the reference's keys.
``m``/``v`` live on the parameters' device; ``step`` is a 0-d int32 on
the host, so the learning rate and the bias corrections are computed
there in float32, as the reference computes them, and never read back
from the card.

AdamW runs its leaves through ``torch._foreach_*`` ops: a handful of
launches for a group of leaves instead of a dozen per leaf. The groups
hold up to ``GROUP_ELEMENTS`` elements (a leaf larger than that is a
group of its own), so the update's float32 temporaries stay within a few
GB however large the model: an LLM at full width keeps only the new
parameters and moments beside the old. Adafactor scales each leaf's
gradient by the clip factor as it reaches it, for the same reason. The
numbers are the same either way: every element sees the same operations.

Placed trees (DTensors, a sharded step of ``training.trainer``): state
leaves take their parameter's placement (Adafactor's factored ``vr``/
``vc`` drop the reduced dim's split, as ``Policy.opt_pspecs`` does).
The global gradient norm sums each leaf's local squares once per
distinct block and all-reduces them; AdamW then runs on each rank's
local blocks (it is elementwise), and Adafactor, whose factored moments
and update clipping reduce over a leaf, gathers one leaf at a time,
updates it whole and keeps its own block.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

from ..distributed import spmd as SP
from . import tree as T


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine to ``min_lr_ratio``; a 0-d float32."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _global_norm(leaves):
    """sqrt of the sum of squares over every leaf: per-leaf norms in one
    foreach launch, then the norm of those. DTensor leaves: each rank's
    local sums of squares, weighted by one over the leaf's replication,
    all-reduced over the mesh (a plain 0-d result, the same everywhere)."""
    if leaves and SP.is_dtensor(leaves[0]):
        return _global_norm_placed(leaves)
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in leaves])))


def _global_norm_placed(leaves):
    from torch.distributed.tensor import Replicate
    mesh = leaves[0].device_mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in leaves:
        rep = 1
        for i, pl in enumerate(g.placements):
            if isinstance(pl, Replicate):
                rep *= mesh.size(i)
        loc = g.to_local().float()
        total += (loc * loc).sum() / rep
    if mesh.size() > 1:
        torch.distributed.all_reduce(total, group=SP.axes_group(
            mesh, SP.mesh_names(mesh)))
    return total.sqrt()


def _as_placed(tree, like):
    """Each DTensor leaf of ``tree`` in the placement of the same leaf of
    ``like`` (AdamW's blocks must line up with the parameter's)."""
    def one(a, r):
        if SP.is_dtensor(a) and tuple(a.placements) != tuple(r.placements):
            return a.redistribute(r.device_mesh, r.placements)
        return a
    return T.tree_map(one, tree, like)


def _local(tree):
    """Each leaf's local block (plain leaves as they are)."""
    return T.tree_map(lambda a: a.to_local() if SP.is_dtensor(a) else a,
                      tree)


def _placed_like(new, ref):
    """Local blocks ``new`` placed as the DTensors of ``ref``."""
    from torch.distributed.tensor import DTensor
    return T.tree_map(
        lambda n, r: DTensor.from_local(n, r.device_mesh, r.placements,
                                        shape=r.shape, stride=r.stride(),
                                        run_check=False)
        if SP.is_dtensor(r) else n, new, ref)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, as float32;
    the norm before scaling). The norm is floored at 1e-9."""
    gn = _global_norm(T.leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return T.tree_map(lambda g: g.float() * scale, grads), gn


GROUP_ELEMENTS = 1 << 28       # 1 GiB of float32 per temporary list


def _groups(leaves):
    """Consecutive index ranges of ``leaves`` of at most GROUP_ELEMENTS
    elements each (at least one leaf a range)."""
    start, size = 0, 0
    for i, x in enumerate(leaves):
        if size and size + x.numel() > GROUP_ELEMENTS:
            yield range(start, i)
            start, size = i, 0
        size += x.numel()
    if start < len(leaves):
        yield range(start, len(leaves))


def _init_step():
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------- AdamW

def _zeros_like(p):
    if SP.is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params):
    zeros = _zeros_like
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": _init_step()}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    if SP.any_dtensor(params):
        grads = _as_placed(grads, params)
        state = dict(state, m=_as_placed(state["m"], params),
                     v=_as_placed(state["v"], params))
        gn = _global_norm(T.leaves(grads))
        new_p, new_s, _ = _adamw(cfg, _local(grads), _local(state),
                                 _local(params), gn)
        return (_placed_like(new_p, params),
                {"m": _placed_like(new_s["m"], state["m"]),
                 "v": _placed_like(new_s["v"], state["v"]),
                 "step": new_s["step"]}, gn)
    return _adamw(cfg, grads, state, params, _global_norm(T.leaves(grads)))


def _adamw(cfg: OptConfig, grads, state, params, gn):
    step = state["step"] + 1
    lr = float(schedule(cfg, step))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - _f32(b1) ** _f32(step))
    bc2 = float(1 - _f32(b2) ** _f32(step))
    p = T.leaves(params)
    g_all = T.leaves(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    m_all, v_all = T.leaves(state["m"]), T.leaves(state["v"])
    new, m, v = [], [], []
    for ix in _groups(p):
        g = torch._foreach_mul([g_all[i].float() for i in ix], scale)
        mg = torch._foreach_mul([m_all[i] for i in ix], b1)
        torch._foreach_add_(mg, g, alpha=1 - b1)
        vg = torch._foreach_mul([v_all[i] for i in ix], b2)
        torch._foreach_mul_(g, g)
        torch._foreach_add_(vg, g, alpha=1 - b2)
        del g
        # u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
        den = torch._foreach_div(vg, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        u = torch._foreach_div(mg, bc1)
        torch._foreach_div_(u, den)
        del den
        pf = [p[i].float() for i in ix]
        if cfg.weight_decay:
            torch._foreach_add_(u, pf, alpha=cfg.weight_decay)
        ng = torch._foreach_add(pf, u, alpha=-lr)
        del u, pf
        new += [n.to(p[i].dtype) for n, i in zip(ng, ix)]
        m += mg
        v += vg
    return (T.unflatten(params, new),
            {"m": T.unflatten(params, m), "v": T.unflatten(params, v),
             "step": step}, gn)


# ------------------------------------------------------------ Adafactor

def _factored(shape):
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def init(p):
        if SP.is_dtensor(p):
            return _adafactor_init_placed(p)
        z = partial(torch.zeros, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}
    return {"v": T.tree_map(init, params), "step": _init_step()}


def _adafactor_init_placed(p):
    """Zero moments of a placed leaf: ``vr`` drops the last dim's split,
    ``vc`` the second-to-last's (the last shifts down one)."""
    from torch.distributed.tensor import Replicate, Shard, zeros
    nd = p.dim()
    if not _factored(p.shape):
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    def drop(dim):
        out = []
        for pl in p.placements:
            if isinstance(pl, Shard) and pl.dim == dim:
                out.append(Replicate())
            elif isinstance(pl, Shard) and pl.dim > dim:
                out.append(Shard(pl.dim - 1))
            else:
                out.append(pl)
        return out
    z = partial(zeros, dtype=torch.float32, device_mesh=p.device_mesh)
    return {"vr": z(p.shape[:-1], placements=drop(nd - 1)),
            "vc": z(p.shape[:-2] + p.shape[-1:], placements=drop(nd - 2))}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    lr = float(schedule(cfg, step))
    # clip_by_global_norm's scaling, leaf by leaf as each is updated
    gnorm = _global_norm(T.leaves(grads))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    beta = float(1.0 - (_f32(step) + 1.0) ** -0.8)

    def upd(p, g, v):
        # the reference's expressions; temporaries of the leaf's size are
        # reused in place (a stacked leaf at full width holds ~1e9 elements)
        g = g.float() * scale
        g2 = g * g
        g2.add_(1e-30)
        if _factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
            del g2
            u = vr[..., None] * vc[..., None, :]
            u.div_(torch.clamp(vr.mean(dim=-1)[..., None, None], min=1e-30))
            nv = {"vr": vr, "vc": vc}
        else:
            u = beta * v["v"] + (1 - beta) * g2
            del g2
            nv = {"v": u.clone()}
        u.add_(1e-30).rsqrt_().mul_(g)          # g * rsqrt(denom + 1e-30)
        del g
        # update clipping (RMS <= 1)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u.div_(torch.clamp(rms, min=1.0))
        u.add_(cfg.weight_decay * p.float())
        u.mul_(lr)
        return torch.sub(p.float(), u).to(p.dtype), nv

    def upd_placed(p, g, v):
        # the leaf gathered whole, updated, and each block kept
        whole = lambda a: a.full_tensor() if SP.is_dtensor(a) else a
        new, nv = upd(whole(p), whole(g), {k: whole(a) for k, a in v.items()})
        return (SP.reshard_like(new, p),
                {k: SP.reshard_like(a, v[k]) for k, a in nv.items()})

    if SP.any_dtensor(params):
        upd_leaf = upd_placed
    else:
        upd_leaf = upd
    # a leaf's state is a dict, so walk the params' paths, not the state's
    vs = {path: v for path, v in _state_at(params, state["v"])}
    outs = [upd_leaf(p, g, vs[path]) for (path, p), g
            in zip(T.paths(params), T.leaves(grads))]
    new_params = T.unflatten(params, [o[0] for o in outs])
    new_v = T.unflatten(params, [o[1] for o in outs])
    return new_params, {"v": new_v, "step": step}, gnorm


def _state_at(params, vtree):
    """(param path, the state dict at that path) for every param leaf."""
    for path, _ in T.paths(params):
        v = vtree
        for k in path:
            v = v[k]
        yield path, v


# ------------------------------------------------------------- factory

def make_optimizer(name: str, **kw):
    cfg = OptConfig(name=name, **kw)
    if name == "adamw":
        return cfg, adamw_init, partial(adamw_update, cfg)
    if name == "adafactor":
        return cfg, adafactor_init, partial(adafactor_update, cfg)
    if name == "sgd":
        def sgd_init(params):
            return {"step": _init_step()}

        @torch.no_grad()
        def sgd_update(grads, state, params):
            step = state["step"] + 1
            lr = float(schedule(cfg, step))
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
            new_params = T.tree_map(
                lambda p, g: (p.float() - lr * g).to(p.dtype), params, grads)
            return new_params, {"step": step}, gnorm
        return cfg, sgd_init, sgd_update
    raise ValueError(name)
