"""Losses and metrics: CE (+top-k accuracy), MSE + Pearson/Spearman.

The port of ``repro.training.losses``: everything reduces in float32,
the same expressions in the same order. Ties rank as the reference ranks
them: top-k keeps the lower class index first (``jax.lax.top_k``), and
Spearman's ranks come from a stable argsort (``jnp.argsort`` is stable,
``torch.argsort`` only with ``stable=True``).
"""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, mask=None):
    """logits: (..., V); labels: (...) int. Returns mean CE."""
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values.detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def topk_accuracy(logits, labels, ks=(1, 3, 5)):
    lf = logits.float().reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1).to(lf.device)
    maxk = max(ks)
    # a stable descending sort: among equal logits the lower index first
    top = torch.sort(lf, dim=-1, descending=True, stable=True).indices[:, :maxk]
    hit = top == lab[:, None].long()
    return {f"top{k}": hit[:, :k].any(dim=1).float().mean() for k in ks}


def mse(pred, target):
    return torch.square(pred.float() - target.float()).mean()


def pearsonr(x, y):
    x = x.float().reshape(-1)
    y = y.float().reshape(-1)
    xm = x - x.mean()
    ym = y - y.mean()
    denom = torch.sqrt((xm * xm).sum() * (ym * ym).sum())
    return (xm * ym).sum() / torch.clamp(denom, min=1e-9)


def _ranks(x):
    """Average-free ranks via a stable argsort (ties broken by order)."""
    order = torch.argsort(x, stable=True)
    r = torch.zeros_like(x)
    r[order] = torch.arange(x.shape[0], dtype=x.dtype, device=x.device)
    return r


def spearmanr(x, y):
    x = x.float().reshape(-1)
    y = y.float().reshape(-1)
    return pearsonr(_ranks(x), _ranks(y))
