"""Parameter conversion between the JAX reference's pytrees and the
port's dicts of tensors.

The JAX package holds parameters as nested dicts and lists of arrays;
the port holds the same structure, same keys, same ``(d_in, d_out)``
dense layout, as tensors. Conversion goes through numpy (the caller
turns the JAX tree into numpy first, e.g. with ``jax.device_get``), so
this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_numpy(tree, device):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device`` (copied, dtype kept: float32 stays float32, and
    the int8 leaves of a quantized sidecar become ``torch.int8``)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(tree):
    """Nested dicts/lists/tuples of tensors -> the same structure of numpy
    arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
