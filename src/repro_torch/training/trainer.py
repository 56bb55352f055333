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
runs its CUDA forward and backward kernels on the card.

Sharding. With parameters, optimizer state and batch placed as DTensors
(``launch.specs.input_specs``), the step is SPMD over their mesh: the
reference's hooks ``constrain`` (activations to batch-split) and
``moe_a2a`` (expert parallelism) reach ``forward_train``, each rank's
loss is over its own rows and the step's loss is their mean
(``distributed.spmd``), the gradients come back in the parameters'
placements, and ``constrain_grads`` is applied to the accumulated
gradients before the optimizer, as in the reference. With plain tensors
nothing of this runs and a hook passes its tensor through unchanged.
"""
from __future__ import annotations

import torch

from ..distributed import spmd as SP
from ..models import transformer as T
from . import losses as LS
from . import optimizer as OPT
from . import tree as TR


def make_loss_fn(cfg, *, constrain=None, kernel="jnp", moe_a2a=None):
    """``loss_fn(params, batch)`` -> the 0-d float32 loss. ``batch``:
    ``{"tokens", "labels"}`` (B, S) or (B, S, ncb) integer tensors and,
    for a ``cond_dim`` config, ``"cond"`` (B, Cs, cond_dim). Sharded
    (DTensor logits), each rank takes the loss of its own rows and the
    result is their mean over the batch axes, the same on every rank."""

    def loss_fn(params, batch):
        logits, extras = T.forward_train(
            params, cfg, batch["tokens"], cond=batch.get("cond"),
            next_tokens=batch["labels"], kernel=kernel, constrain=constrain,
            moe_a2a=moe_a2a)
        labels = batch["labels"]
        mtp = extras.get("mtp_logits")
        region = None
        if SP.is_dtensor(logits):
            region = SP.Region.of(logits)
            logits, labels = region.rows(logits), region.rows(labels)
            mtp = None if mtp is None else region.rows(mtp)
        loss = LS.cross_entropy(logits, labels)
        loss = loss + cfg.router_aux_weight * extras["moe_aux"]
        if mtp is not None:
            loss = loss + 0.3 * LS.cross_entropy(mtp[:, :-1], labels[:, 1:])
        return loss if region is None else region.mean(loss)
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
    new trees fresh tensors (the caller's are never written).
    ``constrain_grads``: applied to the accumulated float32 gradients
    before the optimizer (the reference's hint that turns the gradient
    all-reduce into a reduce-scatter into the parameter shards)."""
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
            acc = [_zeros_f32(p) for p in TR.leaves(params)]
            losses = []
            for m in range(M):
                mb = {k: _rows(a, m * (B // M), (m + 1) * (B // M))
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
        if constrain_grads is not None:
            grads = constrain_grads(grads)
        new_params, new_opt, gnorm = opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt_init


def _zeros_f32(p):
    """A float32 accumulator of ``p``'s shape (and placement)."""
    if SP.is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _rows(a, lo, hi):
    """Rows ``lo:hi`` of a batch leaf; a DTensor keeps its placement where
    the rows divide over its split axes, and is replicated where they do
    not (the policy's fallback)."""
    part = a[lo:hi]
    if not SP.is_dtensor(a):
        return part
    from torch.distributed.tensor import Replicate, Shard
    mesh, want = a.device_mesh, list(a.placements)
    n = 1
    for i, pl in enumerate(want):
        if isinstance(pl, Shard) and pl.dim == 0:
            n *= mesh.size(i)
    if (hi - lo) % n:
        want = [Replicate() if isinstance(pl, Shard) and pl.dim == 0 else pl
                for pl in want]
    if tuple(part.placements) != tuple(want):
        part = part.redistribute(mesh, want)
    return part
