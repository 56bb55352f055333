"""The port's counterpart of ``jax.jit``: a function captured as a CUDA
graph per input signature.

``Graphed(fn)`` wraps ``fn(params, *inputs)``. ``params`` is a tree
(dicts, lists, tuples) of tensors the function reads, and may write, in
place: a graph bakes in the addresses it reads, so parameters are never
copied, and their ``data_ptr()`` is part of the signature. ``inputs``
are trees whose tensors are copied into the graph's static buffers on
every call. Every call is keyed by

  * the tree structure of ``params`` and ``inputs``;
  * each tensor's shape, strides (of the dims longer than 1), dtype and
    device, and for a parameter leaf its address;
  * the value (and type) of each non-tensor leaf;

as the reference's jit cache keys on shapes and static values: a new
bucketed or packed shape, or the int8 sidecar dict, is a new program.
``compile_count()`` is the number of distinct keys seen.

On a CUDA tensor, the first call of a key runs ``fn`` eagerly (the
warm-up, which builds and configures the kernels) and returns that
result; then it captures the same call with ``torch.cuda.graph`` into
static input buffers, the graph with a memory pool of its own. A later
call of the key copies its inputs into the static buffers on the
current stream, replays the graph, and returns clones of the static
outputs: callers keep results (the feature cache, stacked tails) that
the next replay would otherwise overwrite. A failed capture or replay
raises; nothing falls back to the eager call.

On the CPU the wrapper counts keys and runs ``fn`` eagerly, so a CPU
run's ``compile_count()`` is the number of graphs a card run of the
same drive captures.

The kernels' wrappers count their calls and launches in Python, which a
replay does not run: a capture's counts are taken back and added again
on every replay (``kernels.ops.COUNTERS``), so a card run's launches
still equal a CPU run's calls.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import torch

from .kernels import ops as kops


def _signature(tree, leaves: list, *, pinned: bool):
    """A hashable key of ``tree``; appends its tensors to ``leaves`` in
    the order ``_rebuild`` puts them back. ``pinned`` trees (parameters)
    add each tensor's address."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _signature(v, leaves, pinned=pinned))
                              for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_signature(v, leaves, pinned=pinned) for v in tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        # a size-1 dim's stride addresses nothing (a crop of a longer
        # series keeps its parent's): it does not enter the key
        strides = tuple(st if n > 1 else 0
                        for n, st in zip(tree.shape, tree.stride()))
        sig = (tuple(tree.shape), strides, tree.dtype, tree.device)
        return ("tensor", *sig, tree.data_ptr()) if pinned else ("tensor", *sig)
    return ("value", type(tree).__name__, tree)


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in order, by ``tensors`` (an
    iterator)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, tensors) for v in tree)
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    return tree


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]          # the static input buffers
    outputs: object                     # the static outputs (a tree)
    out_leaves: List[torch.Tensor]      # their tensors, in tree order
    counts: List[int]                   # kernel counters' ticks per call


class Graphed:
    """``fn(params, *inputs)`` captured per signature on the card, run
    eagerly (and its signatures counted) on the CPU."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: dict = {}         # key -> _Graph, or None on the CPU
        self.capture_s = 0.0            # host seconds spent capturing

    def compile_count(self) -> int:
        """Distinct signatures seen: on the card, the graphs captured."""
        return len(self._graphs)

    def __call__(self, params, *inputs):
        p_leaves, in_leaves = [], []
        key = (_signature(params, p_leaves, pinned=True),
               _signature(inputs, in_leaves, pinned=False))
        if not any(t.is_cuda for t in p_leaves + in_leaves):
            self._graphs.setdefault(key, None)
            return self.fn(params, *inputs)
        entry = self._graphs.get(key)
        if entry is None:
            out = self.fn(params, *inputs)          # the warm-up call
            self._graphs[key] = self._capture(params, inputs, in_leaves)
            return out
        for static, x in zip(entry.inputs, in_leaves):
            static.copy_(x)
        entry.graph.replay()
        for (fn, attr), n in zip(kops.COUNTERS, entry.counts):
            setattr(fn, attr, getattr(fn, attr) + n)
        return _rebuild(entry.outputs, (t.clone() for t in entry.out_leaves))

    def _capture(self, params, inputs, in_leaves) -> _Graph:
        t0 = time.perf_counter()
        # plain tensors, not inference tensors: later calls copy into
        # them in and out of inference mode alike
        with torch.inference_mode(False):
            static = [x.clone() for x in in_leaves]
        before = [getattr(fn, attr) for fn, attr in kops.COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = self.fn(params, *_rebuild(inputs, iter(static)))
        counts = []
        for (fn, attr), b in zip(kops.COUNTERS, before):
            counts.append(getattr(fn, attr) - b)
            setattr(fn, attr, b)        # capturing launched nothing
        out_leaves: list = []
        _signature(outputs, out_leaves, pinned=False)
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, static, outputs, out_leaves, counts)


def compile_count(fn) -> int:
    """Distinct signatures of a graphed callable (anything with a
    ``compile_count()``, as the reference reads ``_cache_size``); 0 for
    an eager piece."""
    count = getattr(fn, "compile_count", None)
    return count() if callable(count) else 0
