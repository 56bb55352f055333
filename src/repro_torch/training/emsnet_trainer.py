"""EMSNet multitask training, including Progressive Modality Integration.

The port of ``repro.training.emsnet_trainer``. Task selection mirrors the
paper's P / M / Q / P-M / P-Q / M-Q / P-M-Q grid (protocol CE, medicine
CE, quantity MSE). PMI (paper §3.2): the 3-modal model is *not* trained
from scratch on the tiny D2 — the text+vitals encoders come from the
2-modal model trained on the large D1 and are frozen (detached, no
update, no weight decay) while the freshly-initialized scene encoder and
(warm-started) headers integrate the new modality.

Parameters are the port's trees of tensors (``models.emsnet.
init_params``); a step is the forward, autograd's backward and the
optimizer's update, and returns new tensors (the caller's are never
written). Training and evaluation run the reference's materialised
attention (``use_flash_text=False``, set with ``dataclasses.replace`` on
whatever config comes in): the flash kernel has no backward, and its
wrapper raises under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import device as _device
from ..configs.emsnet import EMSNetConfig
from ..models import emsnet as E
from . import losses as LS
from . import optimizer as OPT
from . import tree as T

TASKS = ("protocol", "medicine", "quantity")


def train_config(cfg: EMSNetConfig) -> EMSNetConfig:
    """``cfg`` with the reference's einsum text attention."""
    return dataclasses.replace(cfg, use_flash_text=False)


def to_device(batch, device) -> Dict:
    """A numpy batch from ``data.synthetic_nemsis`` -> tensors on
    ``device`` (same keys, same dtypes). To the card each array goes
    from pinned memory without blocking, so the host can queue the step
    while the previous one runs."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_of(params) -> torch.device:
    return T.leaves(params)[0].device


def multitask_loss(out: dict, labels: dict, tasks=TASKS):
    loss = torch.zeros((), dtype=torch.float32,
                       device=next(iter(out.values())).device)
    parts = {}
    if "protocol" in tasks:
        parts["protocol"] = LS.cross_entropy(out["protocol_logits"],
                                             labels["protocol"])
        loss = loss + parts["protocol"]
    if "medicine" in tasks:
        parts["medicine"] = LS.cross_entropy(out["medicine_logits"],
                                             labels["medicine"])
        loss = loss + parts["medicine"]
    if "quantity" in tasks:
        parts["quantity"] = LS.mse(out["quantity"], labels["quantity"])
        loss = loss + parts["quantity"]
    return loss, parts


def value_and_grad(params, cfg: EMSNetConfig, batch, modalities,
                   tasks=TASKS, *, freeze=()):
    """(multitask loss, gradient tree shaped like ``params``) of one
    batch, under the training config. Frozen subtrees are encoded
    without a graph and get zero gradients, as the reference's."""
    cfg = train_config(cfg)
    batch = to_device(batch, _device_of(params))
    trained = {k: T.tree_map(lambda p: p.detach().requires_grad_(True), v)
               for k, v in params.items() if k not in freeze}
    with torch.enable_grad():
        out = E.forward({**params, **trained}, cfg, batch, modalities,
                        freeze=freeze)
        loss, _ = multitask_loss(out, batch["labels"], tasks)
        flat = torch.autograd.grad(loss, T.leaves(trained))
    grads = {k: T.tree_map(torch.zeros_like, v)
             for k, v in params.items() if k in freeze}
    grads.update(T.unflatten(trained, flat))
    return loss.detach(), grads


def make_train_step(cfg: EMSNetConfig, modalities, tasks=TASKS, *,
                    freeze=(), lr=1e-3):
    """``(step, opt_init)``: ``step(params, opt_state, batch) ->
    (new_params, new_opt_state, loss)`` with ``batch`` a numpy batch.
    Frozen subtrees get no update and come back as the same tensors."""
    opt_cfg, opt_init, opt_update = OPT.make_optimizer(
        "adamw", lr=lr, warmup_steps=20, decay_steps=100_000)

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, cfg, batch, modalities, tasks,
                                     freeze=freeze)
        new_params, opt_state, _gnorm = opt_update(grads, opt_state, params)
        # frozen subtrees stay bit-identical (no weight decay either)
        new_params = {k: (params[k] if k in freeze else v)
                      for k, v in new_params.items()}
        return new_params, opt_state, loss

    return step, opt_init


@torch.inference_mode()
def eval_batch(params, cfg, batch, modalities, tasks=TASKS):
    cfg = train_config(cfg)
    batch = to_device(batch, _device_of(params))
    out = E.forward(params, cfg, batch, modalities)
    metrics = {}
    if "protocol" in tasks:
        metrics.update({f"protocol_{k}": v for k, v in
                        LS.topk_accuracy(out["protocol_logits"],
                                         batch["labels"]["protocol"]).items()})
    if "medicine" in tasks:
        metrics.update({f"medicine_{k}": v for k, v in
                        LS.topk_accuracy(out["medicine_logits"],
                                         batch["labels"]["medicine"]).items()})
    if "quantity" in tasks:
        q, t = out["quantity"], batch["labels"]["quantity"]
        metrics["quantity_mse"] = LS.mse(q, t)
        metrics["quantity_pearsonr"] = LS.pearsonr(q, t)
        metrics["quantity_spearmanr"] = LS.spearmanr(q, t)
    return metrics


def evaluate(params, cfg, ds, modalities, tasks=TASKS, *, batch_size=256):
    accs = []
    for i in range(0, len(ds) - batch_size + 1, batch_size):
        batch = ds.batch(np.arange(i, i + batch_size), modalities)
        accs.append(eval_batch(params, cfg, batch, modalities, tasks))
    if not accs:
        batch = ds.batch(np.arange(len(ds)), modalities)
        accs = [eval_batch(params, cfg, batch, modalities, tasks)]
    keys = list(accs[0])
    vals = torch.stack([torch.stack([a[k].float() for k in keys])
                        for a in accs]).cpu().numpy()      # one read-back
    return {k: float(np.mean(vals[:, j])) for j, k in enumerate(keys)}


def train(cfg: EMSNetConfig, loader, *, modalities, tasks=TASKS, steps=200,
          seed=0, params=None, freeze=(), lr=1e-3, log_every=0,
          device="cuda"):
    """``steps`` AdamW steps over ``loader``'s batches. Without
    ``params`` the model is drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` and placed on ``device``; with them, it trains on their
    device. Returns (params, per-step losses as floats)."""
    step_fn, opt_init = make_train_step(cfg, modalities, tasks,
                                        freeze=freeze, lr=lr)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = E.init_params(cfg, gen, modalities,
                               device=_device.resolve(device))
    opt_state = opt_init(params)
    losses = []
    for i in range(steps):
        batch = next(loader)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(loss)
        if log_every and (i + 1) % log_every == 0:
            recent = torch.stack(losses[-log_every:]).mean()
            print(f"  step {i+1}: loss={float(recent):.4f}", flush=True)
    losses = torch.stack(losses).tolist() if losses else []
    return params, losses


# ----------------------------------------------------------------------
# Progressive Modality Integration
# ----------------------------------------------------------------------

def pmi_init(cfg: EMSNetConfig, params_2modal, *, seed=0,
             base=("text", "vitals"), new="scene", fresh=None):
    """Build 3-modal params from a trained 2-modal model: reuse base
    encoders, fresh scene encoder, warm-started headers (the first
    |F_C^2modal| rows of each header's weight copy the 2-modal weights,
    the biases are the 2-modal ones). ``fresh`` (a 3-modal tree on the
    same device) supplies the fresh scene encoder and headers; without
    it they are drawn from a CPU ``torch.Generator`` seeded with
    ``seed``."""
    modalities = tuple(base) + (new,)
    if fresh is None:
        gen = torch.Generator().manual_seed(seed)
        fresh = E.init_params(cfg, gen, modalities,
                              device=_device_of(params_2modal))
    params = dict(fresh)
    for m in base:
        params[m] = params_2modal[m]
    dims = cfg.feature_dims
    fc2 = sum(dims[m] for m in base)
    heads = {}
    for h in ("protocol", "medicine", "quantity"):
        w = fresh["heads"][h]["w"].clone()
        w[:fc2] = params_2modal["heads"][h]["w"]
        heads[h] = {"w": w, "b": params_2modal["heads"][h]["b"]}
    params["heads"] = heads
    return params, modalities


def pmi_finetune(cfg: EMSNetConfig, params_2modal, loader3, *, steps=200,
                 seed=0, lr=1e-3, freeze_base=True, log_every=0,
                 fresh=None):
    """Stage-2 of PMI: integrate the scene modality on the small D2."""
    params, modalities = pmi_init(cfg, params_2modal, seed=seed, fresh=fresh)
    freeze = ("text", "vitals") if freeze_base else ()
    return train(cfg, loader3, modalities=modalities, steps=steps, seed=seed,
                 params=params, freeze=freeze, lr=lr, log_every=log_every)
