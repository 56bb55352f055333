"""SPMD steps over a ``DeviceMesh``: the port's counterpart of GSPMD's
partitioning of the reference's jitted steps.

A sharded step keeps its parameters, caches and batch as DTensors placed
by ``sharding.Policy`` and runs each piece of the model (the embedding,
a period of layers, the head, the loss) as a ``Region``: the activation
is taken as this rank's batch rows (its ``Shard(0)`` axes are the
region's *batch axes*; on every other axis the rows are replicated),
each weight is all-gathered at use (ZeRO-3), the piece runs on plain
local tensors, and its output becomes a DTensor with the activation's
placements again. Hand-written kernels therefore only ever see local
tensors: a DTensor has no storage of its own for a raw pointer.

Gradients follow the placements. A weight gathered in a region gets its
gradient back as a partial sum over the batch axes (each rank saw its
own rows) and replicated over the others, so the backward of the gather
is a reduce-scatter (or an all-reduce) into the weight's own placement.
A loss is the mean of the ranks' local losses (``mean_over``): its
backward hands each rank ``1/n`` and needs no collective.

Nothing here runs for plain tensors: the model's unsharded path never
builds a region.
"""
from __future__ import annotations

import math

import torch

_GROUPS = {}
_DTENSOR = []


def is_dtensor(x):
    if not _DTENSOR:
        if not torch.distributed.is_available():
            return False
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def any_dtensor(tree):
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(any_dtensor(v) for v in tree)
    return is_dtensor(tree)


def refuse_dtensor(name, *tensors):
    """Kernel launchers read raw pointers: a DTensor must be unwrapped to
    its local shard before it reaches one."""
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(f"{name}: got a DTensor; run the kernel on its "
                            "local shard (distributed.spmd.Region)")


def mesh_names(mesh):
    return tuple(mesh.mesh_dim_names)


def axes_size(mesh, axes):
    names = mesh_names(mesh)
    return math.prod(mesh.size(names.index(a)) for a in axes)


def axes_rank(mesh, axes):
    """This rank's index along ``axes`` flattened in mesh order (the
    major-to-minor order in which a dim sharded over them is split)."""
    names = mesh_names(mesh)
    coord = mesh.get_coordinate()
    r = 0
    for a in axes:
        i = names.index(a)
        r = r * mesh.size(i) + coord[i]
    return r


def axes_group(mesh, axes):
    """The process group of this rank's ranks along ``axes`` (the other
    axes fixed); group ranks run in mesh order. One axis is the mesh's
    own group; several are built once, by every rank together."""
    names = mesh_names(mesh)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        ids = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(ids.dim()) if i not in dims]
        ids = ids.permute(rest + dims).reshape(-1, math.prod(
            ids.shape[i] for i in dims))
        mine = None
        for row in ids.tolist():
            g = torch.distributed.new_group(row)
            if torch.distributed.get_rank() in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def forget_groups():
    """Drop the groups ``axes_group`` built: they die with the process
    group they were made in, and a later mesh may reuse a dead mesh's
    ``id``."""
    _GROUPS.clear()


def mean_over(x, mesh, axes):
    """The mean of ``x`` over the ranks along ``axes``, on every rank.
    Backward: each rank's local ``x`` gets ``1/n`` of the (replicated)
    incoming gradient, with no collective."""
    axes = tuple(axes)
    n = axes_size(mesh, axes) if axes else 1
    if n == 1:
        return x
    return _MeanOver.apply(x, axes_group(mesh, axes), n)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        out = x.detach().clone()
        torch.distributed.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def all_reduce_mean(x, mesh, axes):
    """``pmean``: the mean over ``axes`` on every rank, differentiable
    (the backward sums every rank's gradient, as each rank's output is
    its own use)."""
    axes = tuple(axes)
    n = axes_size(mesh, axes) if axes else 1
    if n == 1:
        return x
    return _AllReduceSum.apply(x, axes_group(mesh, axes)) / n


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def scale_grad(x, s):
    """``x`` unchanged; its gradient scaled by ``s`` on the way back."""
    return x if s == 1 else _ScaleGrad.apply(x, s)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_to_all(x, mesh, axes):
    """``lax.all_to_all(x, axes, 0, 0, tiled=False)``: chunk ``j`` of
    dim 0 goes to rank ``j`` along ``axes``, and chunk ``j`` of the
    result came from rank ``j``. Differentiable: the backward is the
    same exchange of the gradient (with equal chunks it is its own
    reverse)."""
    n = axes_size(mesh, axes)
    if n == 1:
        return x
    return _AllToAll.apply(x, axes_group(mesh, axes))


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    torch.distributed.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def shard_placements(mesh, axes, dim=0):
    """``Shard(dim)`` on ``axes``, ``Replicate()`` on every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dim) if a in axes else Replicate()
                 for a in mesh_names(mesh))


def local(t, mesh, axes, *, partial=(), dim=0):
    """This rank's block of ``t`` sharded at ``dim`` over ``axes`` and
    replicated elsewhere, as a plain tensor. ``t`` is a DTensor (gathered
    or sliced as needed) or a plain tensor holding the whole value on
    every rank (sliced). The gradient of the block is declared a partial
    sum over the axes in ``partial`` (the ranks there computed from
    different rows) and the block's own placement elsewhere."""
    from torch.distributed.tensor import DTensor, Partial
    want = shard_placements(mesh, axes, dim)
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, shard_placements(mesh, ()),
                               run_check=False)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    grads = tuple(Partial() if (a in partial and a not in axes) else p
                  for a, p in zip(mesh_names(mesh), want))
    return t.to_local(grad_placements=grads)


class Region:
    """One piece of a sharded step: rows split over ``axes`` (the batch
    axes), replicated over the rest of ``mesh``."""

    def __init__(self, mesh, axes):
        names = mesh_names(mesh)
        self.mesh = mesh
        self.axes = tuple(a for a in names if a in axes)

    @classmethod
    def of(cls, x):
        """The region of an activation DTensor: its ``Shard(0)`` axes are
        the batch axes. Any other split is refused."""
        from torch.distributed.tensor import Replicate, Shard
        axes = []
        for a, p in zip(mesh_names(x.device_mesh), x.placements):
            if isinstance(p, Shard) and p.dim == 0:
                axes.append(a)
            elif not isinstance(p, Replicate):
                raise ValueError(f"activation placed {x.placements}: only "
                                 "Shard(0) and Replicate() run in a region")
        return cls(x.device_mesh, axes)

    def placements(self, dim=0):
        return shard_placements(self.mesh, self.axes, dim)

    def rows(self, x, dim=0):
        """This rank's rows of an activation (DTensor or whole plain
        tensor), split at ``dim``."""
        return local(x, self.mesh, self.axes, dim=dim)

    def wrap(self, x_local, dim=0):
        """A local block back as a DTensor with the region's placements."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(x_local, self.mesh, self.placements(dim),
                                  run_check=False)

    def gather(self, t):
        """A weight (or any DTensor) whole on this rank, its gradient a
        partial sum over the batch axes."""
        return local(t, self.mesh, (), partial=self.axes)

    def params(self, tree, keep=lambda path: False, path=()):
        """Every DTensor leaf of ``tree`` gathered, except the subtrees
        at the paths ``keep`` accepts, which stay as they are."""
        if keep(path):
            return tree
        if isinstance(tree, dict):
            return {k: self.params(v, keep, path + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.params(v, keep, path + (i,))
                              for i, v in enumerate(tree))
        return self.gather(tree) if is_dtensor(tree) else tree

    def index(self):
        """This rank's block index along the batch axes."""
        return axes_rank(self.mesh, self.axes)

    def mean(self, x):
        """A local loss averaged over the batch axes (``mean_over``)."""
        return mean_over(x, self.mesh, self.axes)


def reshard_like(full, ref):
    """A whole plain tensor placed as the DTensor ``ref`` (each rank
    keeps a copy of its block, so the whole tensor can be freed; no
    communication)."""
    from torch.distributed.tensor import DTensor
    out = place(full, ref.device_mesh, ref.placements)
    block = out.to_local()
    if block.numel() < full.numel():
        out = DTensor.from_local(block.clone(), ref.device_mesh,
                                 ref.placements, shape=ref.shape,
                                 stride=ref.stride(), run_check=False)
    return out


def place(tensor, mesh, spec_placements):
    """A whole plain tensor (the same on every rank) as a DTensor with the
    given placements: each rank keeps its own block, nothing is sent. On
    a one-rank mesh the DTensor shares the tensor's storage."""
    from torch.distributed.tensor import DTensor
    rep = DTensor.from_local(tensor, mesh, shard_placements(mesh, ()),
                             run_check=False)
    return rep.redistribute(mesh, tuple(spec_placements))
