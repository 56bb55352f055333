"""Per-device counts of one step, from the aten ops it dispatches.

The port of ``repro.analysis.hlo_analyzer``. The reference walks the
compiled (post-SPMD, per-device) HLO text; the port has no compiled
module, so ``analyze_step(fn, *args)`` runs the step once under a
``TorchDispatchMode`` and walks the aten ops it dispatches, backward
included for a training step (the step's own ``backward`` runs inside
the call). On ``meta`` tensors and a fake process group the step
allocates and computes nothing (``launch/dryrun.py``).

Per-op contributions, the reference's rules:
  * flops: matmul-family ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``mv``, ``dot``; ``matmul`` and ``einsum`` reach the dispatcher as
    these) — 2 x numel(result) x contracted size;
  * collective bytes by kind: result-buffer bytes and counts of
    ``_c10d_functional`` all-gather / reduce-scatter / all-reduce /
    all-to-all (and their ``_c10d_functional_autograd`` twins), and of
    the ``c10d`` ops ``torch.distributed.all_reduce`` and
    ``all_to_all_single`` dispatch (their output argument is the result);
    each op is seen once, so a collective counts once;
  * hbm bytes: result bytes of materialising ops (views, ``empty`` and
    the collectives' wait/wrap no-ops excluded) — an op-granularity
    upper bound, as the reference's is a fusion-granularity one.

Per device. An op with DTensor arguments is not counted at its global
shapes: the mode hands it back to DTensor (``NotImplemented``), which
runs it as local ops on this rank's blocks, plus the collectives its
redistributions need, and those are counted. The ops DTensor runs on
``FakeTensor``s to propagate shapes are not counted either.

Loops. The reference multiplies a ``while`` body by its trip count; the
port's Python loops over layers are simply walked. A scan over time
walked step by step on ``meta`` would cost minutes at S=32k, so the
port's scans run one step inside ``trips(S)``, which scales everything
counted inside it, and skip the rest on ``meta`` (``scan_steps``,
``stack_steps``). The step's backward, which autograd runs after
``trips`` has exited, is scaled too: ``trips`` notes the sequence
numbers of the autograd nodes created inside it, and an op that runs
as the backward of one of those nodes counts ``n`` times.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace.name, no overload) -> collective kind: the
# functional collectives DTensor's redistributions dispatch (and their
# autograd twins), and the c10d ops behind ``torch.distributed.all_reduce``
# and ``all_to_all_single``, which write into their first argument
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
COLLECTIVE_OPS = {
    **{f"{ns}.{n}": k for ns in ("_c10d_functional", "_c10d_functional_autograd")
       for n, k in _FUNCTIONAL.items()},
    "c10d.allreduce_": "all-reduce", "c10d.alltoall_base_": "all-to-all",
}

# op name -> index of the argument whose last dim is contracted
DOT_OPS = {"aten.mm": 0, "aten.bmm": 0, "aten.addmm": 1, "aten.baddbmm": 1,
           "aten.mv": 0, "aten.dot": 0}

# results that materialise nothing new (the reference's SKIP_BYTES_OPS:
# parameters, tuples, bitcasts, constants); view ops are skipped by
# their schema
SKIP_BYTES_OPS = {"aten.empty", "aten.empty_like", "aten.empty_strided",
                  "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
                  "_c10d_functional.wait_tensor",
                  "_c10d_functional._wrap_tensor_autograd"}


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    coll_count: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))

    def add(self, other: "Totals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in COLLECTIVES:
            self.coll[k] += other.coll[k] * mult
            self.coll_count[k] += other.coll_count[k] * mult


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x):
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dot_flops(name, args, out):
    lhs = args[DOT_OPS[name]]
    contracted = lhs.numel() if name == "aten.dot" else lhs.shape[-1]
    return 2.0 * out.numel() * contracted


class _Counter(TorchDispatchMode):
    """Adds each dispatched op's contribution, times ``mult``, to
    ``totals``."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        super().__init__()
        self.dtensor, self.fake = DTensor, FakeTensor
        self.totals = Totals()
        self.mult = 1.0
        self.node_trips = []    # (first, end, n): autograd nodes made in trips(n)

    def _mult(self):
        m = self.mult
        node = torch._C._current_autograd_node() if self.node_trips else None
        if node is not None:
            seq = node._sequence_nr()
            for first, end, n in self.node_trips:
                if first <= seq < end:
                    m *= n
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented          # DTensor runs it on local blocks
        out = func(*args, **kwargs)
        if any(issubclass(t, self.fake) for t in types):
            return out                     # DTensor's shape propagation
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        t, m = self.totals, self._mult()
        if name in DOT_OPS:
            t.flops += m * _dot_flops(name, args, out)
        kind = COLLECTIVE_OPS.get(name)
        result = args[0] if kind and func.namespace == "c10d" else out
        if kind:
            t.coll[kind] += m * _nbytes(result)
            t.coll_count[kind] += m
        if not (func.is_view or name in SKIP_BYTES_OPS):
            t.bytes += m * _nbytes(result)
        return out


def _next_sequence_nr(counters):
    """The sequence number the next autograd node will get (a throwaway
    node is made for it, counted by no one)."""
    for c, _ in counters:
        c.mult = 0.0
    with torch.enable_grad():
        probe = torch.empty((), device="meta", requires_grad=True) * 1
    return probe.grad_fn._sequence_nr() + 1


@contextlib.contextmanager
def trips(n):
    """Everything counted inside is counted ``n`` times, by every active
    ``analyze_step`` (the counterpart of a ``while`` loop's trip count),
    and so is the backward of every autograd node made inside. Outside
    ``analyze_step`` it does nothing."""
    counters = [(m, m.mult) for m in _get_current_dispatch_mode_stack()
                if isinstance(m, _Counter)]
    if not counters:
        yield
        return
    first = _next_sequence_nr(counters)
    for c, mult in counters:
        c.mult = mult * n
    try:
        yield
    finally:
        end = _next_sequence_nr(counters)
        for c, mult in counters:
            c.mult = mult
            if end > first:
                c.node_trips.append((first, end, n))


def scan_steps(S, x):
    """The time steps a plain scan over ``x`` walks: ``range(S)``, or on
    a ``meta`` tensor the one step 0 inside ``trips(S)``, whose outputs
    the scan then repeats for every step (the same ops run at every
    step, so the counts are the walk's)."""
    if x.device.type != "meta":
        yield from range(S)
        return
    with trips(S):
        yield 0


def stack_steps(ys, S, dim=1):
    """``torch.stack(ys, dim)`` of a scan's S step outputs; on ``meta``,
    where ``scan_steps`` ran one step, that step's output laid out S
    times (one result of the stack's bytes, one edge for autograd)."""
    if len(ys) == S:
        return torch.stack(ys, dim=dim)
    y, = ys
    return y.unsqueeze(dim).expand(*y.shape[:dim], S,
                                   *y.shape[dim:]).contiguous()


def analyze_step(fn, *args) -> Totals:
    """``fn(*args)`` once, under the counting mode; its per-device
    ``Totals``."""
    counter = _Counter()
    with counter:
        fn(*args)
    return counter.totals
