"""Mesh construction: ``DeviceMesh``es with the reference's axis names.

The port of ``repro.launch.mesh``. Functions, not module-level
constants, so importing this module never starts a process group.

``make_host_mesh`` is the 1x1 ``('data', 'model')`` mesh over the one
device of this process: on the card an NCCL process group of world size
1 (with gloo beside it for CPU tensors, so a CPU mesh can share the
group), on the CPU a gloo one. It starts that group itself when none exists,
with a ``FileStore`` under the checkout's git-ignored ``build/mesh/``
for its rendezvous (``close_mesh`` destroys the group and removes the
file). ``make_production_mesh`` lays (16, 16) or (2, 16, 16) over the
ranks of an existing process group and raises when the world is smaller,
as the reference raises when it has fewer devices.

Asking for the card on a machine without one raises: a mesh never falls
back to the CPU.
"""
from __future__ import annotations

import os
import uuid
from pathlib import Path

import torch

from .. import device as _device

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")
STORE_DIR = Path(__file__).resolve().parents[3] / "build" / "mesh"

_STORE = {}


def _device_type(device):
    return _device.resolve(device).type


def make_host_mesh(device="cuda"):
    """1x1 ``('data', 'model')`` mesh over the single device of this
    process (tests, one-card steps). Starts a one-rank process group
    (NCCL on the card, gloo on the CPU) unless one is running; a running
    group must have world size 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    if not dist.is_initialized():
        if kind == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        STORE_DIR.mkdir(parents=True, exist_ok=True)
        path = STORE_DIR / f"host-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if kind == "cuda" else "gloo",
            store=dist.FileStore(str(path), 1), rank=0, world_size=1)
        _STORE["path"] = path
    elif dist.get_world_size() != 1:
        raise RuntimeError(
            f"make_host_mesh: a process group of {dist.get_world_size()} "
            "ranks is running; the host mesh is one rank")
    return init_device_mesh(kind, (1, 1), mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) ``('data', 'model')`` or, with ``multi_pod``, (2, 16, 16)
    ``('pod', 'data', 'model')`` over the first ranks of the running
    process group (its ranks in row-major order)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MULTI_POD_AXES if multi_pod else AXES
    n = 1
    for s in shape:
        n *= s
    kind = _device_type(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks, have {world}: start a process group of {n} "
            "ranks (torch.distributed.init_process_group) before building "
            "the production mesh")
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def close_mesh():
    """Destroy the process group ``make_host_mesh`` started (if it did)
    and remove its store file."""
    import torch.distributed as dist

    from ..distributed.spmd import forget_groups
    path = _STORE.pop("path", None)
    if path is None:
        return
    if dist.is_initialized():
        forget_groups()
        dist.destroy_process_group()
    path.unlink(missing_ok=True)
