"""Checkpointing: a tree of tensors <-> .npz + structure JSON.

The port of ``repro.training.checkpoint``, in its format: leaves are
saved under their joined tree path (dict keys and list indices joined by
``/``, e.g. ``text/blocks/0/wqkv/w``, as JAX's
``tree_flatten_with_path`` names them), next to a ``.json`` holding
``{"keys", "metadata"}``. A file written by either package restores in
the other. Restore validates every leaf's shape against a template and
places it on the template leaf's device, in its dtype.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..convert import to_numpy
from . import tree as T


def _key(path):
    return "/".join(str(k) for k in path)


def _flatten(tree):
    return {_key(p): to_numpy(leaf) for p, leaf in T.paths(tree)}


def save(path, tree, *, metadata=None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    meta = {"keys": sorted(flat), "metadata": metadata or {}}
    path.with_suffix(".json").write_text(json.dumps(meta, indent=1))


def restore(path, template):
    """Restore into the structure of ``template`` (shapes must match),
    each leaf on the template leaf's device and in its dtype."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    new = []
    with np.load(path) as data:
        for p, leaf in T.paths(template):
            key = _key(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            new.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
    return T.unflatten(template, new)


def metadata(path):
    p = Path(path).with_suffix(".json")
    return json.loads(p.read_text())["metadata"]
