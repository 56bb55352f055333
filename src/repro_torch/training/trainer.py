"""LM training step of the LLM zoo: cross-entropy (+ the MTP head's, + the
MoE load-balance loss), microbatched gradient accumulation, the config's
optimizer.

The port of ``repro.training.trainer``. The loss is
``CE(logits, labels) + router_aux_weight * moe_aux`` and, for an ``mtp``
config, ``+ 0.3 * CE(mtp_logits[:, :-1], labels[:, 1:])``. A step splits
the batch into ``cfg.train_microbatches`` microbatches along its first
axis, runs autograd's backward on each and accumulates the gradients as
float32 ``g / M`` leaf by leaf (in place, in the reference's leaf order);
its loss is the mean of the microbatch losses. With one microbatch the
gradients are cast to float32. Then the optimizer (``cfg.optimizer`` or
``optimizer=``) updates the tree. Loss and grad norm come back as 0-d
tensors on the parameters' device: nothing is read back to the host
inside a step.

``kernel`` is passed to ``forward_train``: "jnp" (the default, as the
reference's) runs the plain attention; "pallas" reaches the flash
kernel, which has no backward and raises under autograd. The RWKV6 scan
runs its CUDA forward and backward kernels on the card. The reference's
sharding hooks (``constrain``, ``constrain_grads``, ``moe_a2a``) belong
to ROADMAP item 12: any that is not None raises.
"""
from __future__ import annotations

import torch

from ..models import transformer as T
from . import losses as LS
from . import optimizer as OPT
from . import tree as TR


def make_loss_fn(cfg, *, constrain=None, kernel="jnp", moe_a2a=None):
    """``loss_fn(params, batch)`` -> the 0-d float32 loss. ``batch``:
    ``{"tokens", "labels"}`` (B, S) or (B, S, ncb) integer tensors and,
    for a ``cond_dim`` config, ``"cond"`` (B, Cs, cond_dim)."""
    T._check_hooks(constrain=constrain, moe_a2a=moe_a2a)

    def loss_fn(params, batch):
        logits, extras = T.forward_train(
            params, cfg, batch["tokens"], cond=batch.get("cond"),
            next_tokens=batch["labels"], kernel=kernel)
        loss = LS.cross_entropy(logits, batch["labels"])
        loss = loss + cfg.router_aux_weight * extras["moe_aux"]
        if "mtp_logits" in extras:
            mtp = extras["mtp_logits"]
            loss = loss + 0.3 * LS.cross_entropy(mtp[:, :-1],
                                                 batch["labels"][:, 1:])
        return loss
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient leaves in the tree's leaf order) of one batch:
    every leaf a fresh autograd leaf, the caller's tensors untouched."""
    live = TR.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, TR.leaves(live))
    return loss.detach(), grads


def make_train_step(cfg, *, optimizer=None, constrain=None, kernel="jnp",
                    constrain_grads=None, moe_a2a=None):
    """Returns (train_step, opt_init). ``train_step(params, opt_state,
    batch)`` -> (new_params, new_opt_state, {"loss", "grad_norm"}), the
    new trees fresh tensors (the caller's are never written)."""
    T._check_hooks(constrain_grads=constrain_grads)
    _, opt_init, opt_update = OPT.make_optimizer(optimizer or cfg.optimizer)
    loss_fn = make_loss_fn(cfg, constrain=constrain, kernel=kernel,
                           moe_a2a=moe_a2a)

    def train_step(params, opt_state, batch):
        M = cfg.train_microbatches
        if M > 1:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} does not split into {M} "
                                 "microbatches")
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in TR.leaves(params)]
            losses = []
            for m in range(M):
                mb = {k: a[m * (B // M):(m + 1) * (B // M)]
                      for k, a in batch.items()}
                loss, g = value_and_grad(loss_fn, params, mb)
                for s, gi in zip(acc, g):
                    s.add_(gi.float() / M)
                del g
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:
            loss, g = value_and_grad(loss_fn, params, batch)
            acc = [gi.float() for gi in g]
        grads = TR.unflatten(params, acc)
        new_params, new_opt, gnorm = opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init
