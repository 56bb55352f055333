"""Parameter conversion between the JAX reference's pytrees and the
port's dicts of tensors.

The JAX package holds parameters as nested dicts and lists of arrays;
the port holds the same structure, same keys, same ``(d_in, d_out)``
dense layout, as tensors. Conversion goes through numpy (the caller
turns the JAX tree into numpy first, e.g. with ``jax.device_get``), so
this module needs no JAX.

bfloat16 leaves: numpy has no bfloat16 of its own. JAX hands them over
as the ``ml_dtypes`` type named ``bfloat16``, which ``torch.from_numpy``
refuses. They are recognised by that name, read through a ``uint16``
view of the same bits and come out as ``torch.bfloat16`` — no
``ml_dtypes`` import, bit for bit. ``to_numpy`` hands bfloat16 tensors
back as float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_tensor(a, device):
    a = np.array(a)                                  # a copy, C-contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_numpy(tree, device):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device`` (copied, dtype kept: float32 stays float32,
    bfloat16 becomes ``torch.bfloat16``, and the int8 leaves of a
    quantized sidecar become ``torch.int8``)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device) for v in tree)
    return _leaf_to_tensor(tree, device)


def to_numpy(tree):
    """Nested dicts/lists/tuples of tensors -> the same structure of numpy
    arrays (on the host). bfloat16 tensors come back as float32 (exact)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
