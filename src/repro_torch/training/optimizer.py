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
launches for the whole tree instead of a dozen per leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import torch

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
    foreach launch, then the norm of those."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in leaves])))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global norm of at most ``max_norm``, as float32;
    the norm before scaling). The norm is floored at 1e-9."""
    gn = _global_norm(T.leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return T.tree_map(lambda g: g.float() * scale, grads), gn


def _init_step():
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------- AdamW

def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params),
            "step": _init_step()}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    lr = float(schedule(cfg, step))
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - _f32(b1) ** _f32(step))
    bc2 = float(1 - _f32(b2) ** _f32(step))
    p = T.leaves(params)
    g = T.leaves(grads)
    gn = _global_norm(g)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    g = torch._foreach_mul([x.float() for x in g], scale)
    m = torch._foreach_mul(T.leaves(state["m"]), b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    v = torch._foreach_mul(T.leaves(state["v"]), b2)
    torch._foreach_mul_(g, g)
    torch._foreach_add_(v, g, alpha=1 - b2)
    # u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    u = torch._foreach_div(m, bc1)
    torch._foreach_div_(u, den)
    pf = [x.float() for x in p]
    if cfg.weight_decay:
        torch._foreach_add_(u, pf, alpha=cfg.weight_decay)
    new = torch._foreach_add(pf, u, alpha=-lr)
    new = [n.to(x.dtype) for n, x in zip(new, p)]
    return (T.unflatten(params, new),
            {"m": T.unflatten(params, m), "v": T.unflatten(params, v),
             "step": step}, gn)


# ------------------------------------------------------------ Adafactor

def _factored(shape):
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def init(p):
        z = partial(torch.zeros, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}
    return {"v": T.tree_map(init, params), "step": _init_step()}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    step = state["step"] + 1
    lr = float(schedule(cfg, step))
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    beta = float(1.0 - (_f32(step) + 1.0) ** -0.8)

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                   min=1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
            nv = {"vr": vr, "vc": vc}
        else:
            nv_ = beta * v["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(nv_ + 1e-30)
            nv = {"v": nv_}
        # update clipping (RMS <= 1)
        rms = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), nv

    # a leaf's state is a dict, so walk the params' paths, not the state's
    vs = {path: v for path, v in _state_at(params, state["v"])}
    outs = [upd(p, g, vs[path]) for (path, p), g
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
