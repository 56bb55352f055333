"""The RWKV6 time-mix recurrence: the hand-written CUDA kernel and its
plain PyTorch version.

``rwkv6_scan`` is the port of the Pallas TPU kernel
``repro/kernels/rwkv6.py::rwkv6_scan``; it computes what the oracles
``repro/kernels/ref.py::rwkv6_ref`` and ``repro/models/rwkv.py::
_wkv_scan`` compute. Per (batch, head), with the (n, n) state S:

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

starting from ``s0`` (zeros when absent). Returns ``(y, final_state)``,
the kernel's order (``_wkv_scan`` returns ``(state, y)``).

r, k and v may be float32, bfloat16 or float16 (the three alike), as the
Pallas body casts them as it loads them; w, u and s0 are float32, and y
and the final state come out float32 whatever r/k/v's type. The
conversion is exact, so a half-type call equals the float32 call on the
up-cast inputs bit for bit.

On a CUDA tensor it launches ``csrc/rwkv6.cu`` (head dim n <= 64; built
with ``nvcc`` for ``sm_90a`` at first use) once per call, split over the
state's value columns and chunked over time as ``plan_chunks`` says, or
raises; on a CPU tensor it computes ``rwkv6_scan_plain``, and on a
``meta`` tensor (the dry run's shapes) the same, one step counted S times
(``analysis.hlo_analyzer.trips``). Nothing falls back from one to the
other. ``rwkv6_scan.launches`` counts kernel launches,
``rwkv6_scan.calls`` every call on any device.

Gradients. Under grad mode, when any input requires grad, the scan runs
through ``RWKV6Scan`` (a ``torch.autograd.Function``): the forward as
above, and a backward through ``rwkv6_scan_backward``, which launches the
backward entry point of ``csrc/rwkv6.cu`` on the card (a thread-block
cluster per (batch, head) over its column slices, in chunks, as
``plan_backward`` says) and computes ``rwkv6_scan_backward_plain`` on the
CPU (its own ``calls`` and ``launches``). With G_t = dL/dS_t (G_S = dL/d
final state) and A_t = S_{t-1} + diag(u) k_t^T v_t:

    dr_t = A_t dy_t                 du = sum_t r_t * k_t (v_t . dy_t)
    dk_t = (G_t + diag(u * r_t) 1 dy_t^T) v_t
    dv_t = (G_t + diag(u * r_t) 1 dy_t^T)^T k_t
    dw_t = rowsum(G_t * S_{t-1})    G_{t-1} = diag(w_t) G_t + r_t^T dy_t
    ds0 = G_0

Under ``torch.no_grad()`` or ``torch.inference_mode()`` (serving) the
forward is called directly, as before, and nothing is saved.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..analysis.hlo_analyzer import scan_steps, stack_steps
from ..distributed.spmd import refuse_dtensor

MAX_HEAD_DIM = 64
# csrc/rwkv6.cu: state columns a block owns, and the chunk lengths it
# compiles (1: one step at a time)
COLS_PER_BLOCK = 16
CHUNKS = (1, 16)
# the types r, k and v may come in (the three alike), by the kernel's
# dtype code; w, u and s0 are float32
RKV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def plan_chunks(B, S, H, n):
    """``(chunk, col_blocks)`` for the CUDA kernel: each (batch, head)
    state is split over ``col_blocks`` blocks of ``COLS_PER_BLOCK`` value
    columns, so the grid is ``B * H * col_blocks`` blocks, and the time
    axis runs in chunks of ``chunk`` steps: 16 for a prompt, 1 (the step
    kernel) for a decode step, where a chunk's phases would be the whole
    cost."""
    if not 1 <= n <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {n} outside 1..{MAX_HEAD_DIM}")
    step, chunk = CHUNKS
    return (step if S == 1 else chunk), -(-n // COLS_PER_BLOCK)


def rwkv6_scan_plain(r, k, v, w, u, s0=None):
    """r/k/v/w: (B, S, H, n); u: (H, n); s0: (B, H, n, n) or None. The
    sequential recurrence in float32 (every input up-cast, exactly), step
    by step as the oracle's scan.
    Returns (y (B, S, H, n), final_state (B, H, n, n)), float32."""
    B, S, H, n = r.shape
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in scan_steps(S, r):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,n,n)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return stack_steps(ys, S), s


def rwkv6_scan_backward_plain(r, k, v, w, u, s0, dy, dsf):
    """The scan's gradients, step by step in float32: the states S_0 ..
    S_{S-1} by the forward recurrence, then G walked back from ``dsf``
    (zeros when None) as the module docstring says. ``s0`` None means
    zeros. Returns (dr, dk, dv, dw (B, S, H, n), du (H, n), ds0 (B, H,
    n, n)), float32."""
    B, S, H, n = r.shape
    r, k, v, w, u, dy = (a.float() for a in (r, k, v, w, u, dy))
    s = (torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    prev = [s] * S                              # S_{t-1} of every step t
    for t in scan_steps(S, r):
        prev[t] = s
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = (torch.zeros_like(s) if dsf is None else dsf.float())
    dr, dk, dv, dw = ([None] * S for _ in range(4))
    du = torch.zeros_like(u)
    for t in (S - 1 - i for i in scan_steps(S, r)):
        rt, kt, vt, wt, dyt = (a[:, t] for a in (r, k, v, w, dy))  # (B,H,n)
        vdy = (vt * dyt).sum(-1, keepdim=True)                     # (B,H,1)
        dr[t] = torch.einsum("bhij,bhj->bhi", prev[t], dyt) + u * kt * vdy
        m = g + (u * rt)[..., None] * dyt[..., None, :]            # (B,H,n,n)
        dk[t] = torch.einsum("bhij,bhj->bhi", m, vt)
        dv[t] = torch.einsum("bhij,bhi->bhj", m, kt)
        dw[t] = (g * prev[t]).sum(-1)
        du = du + (rt * kt * vdy).sum(0)
        g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    if r.device.type == "meta":                 # one step stood for all
        dr, dk, dv, dw = ([x[-1]] for x in (dr, dk, dv, dw))
    return (*(stack_steps(x, S) for x in (dr, dk, dv, dw)), du, g)


def _kernel_fn():
    """The C entry point of csrc/rwkv6.cu, typed once."""
    from . import build
    fn = build.library("rwkv6").repro_rwkv6_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _backward_fn():
    """The backward's C entry point in csrc/rwkv6.cu, typed once."""
    from . import build
    fn = build.library("rwkv6").repro_rwkv6_scan_backward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 15 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def _launch_checks(r, k, v, w, u, s0):
    """What both CUDA entry points refuse, before any build or launch."""
    B, S, H, n = r.shape
    if n > MAX_HEAD_DIM:
        raise ValueError(f"head dim {n} > {MAX_HEAD_DIM}: the CUDA RWKV6 "
                         "kernel holds a 64-row state slice per block")
    if S < 1 or B * H == 0:
        raise ValueError(f"empty scan: B={B}, S={S}, H={H}")
    args = (r, k, v, w, u) + ((s0,) if s0 is not None else ())
    if not (r.dtype == k.dtype == v.dtype and r.dtype in RKV_DTYPES) or any(
            a.dtype != torch.float32 for a in args[3:]):
        raise TypeError("the CUDA RWKV6 kernel takes r/k/v of one dtype, "
                        "float32, bfloat16 or float16, and float32 w/u/s0; "
                        f"got {[a.dtype for a in args]}")
    if any(a.device != r.device for a in args):
        raise ValueError("r, k, v, w, u and s0 must be on one device")
    if any(not a.is_contiguous() for a in args):
        raise ValueError("the CUDA RWKV6 kernel takes contiguous r/k/v/w "
                         "(B, S, H, n), u (H, n) and s0 (B, H, n, n)")


def _launch(r, k, v, w, u, s0, chunk=None):
    B, S, H, n = r.shape
    _launch_checks(r, k, v, w, u, s0)
    chunk = chunk or plan_chunks(B, S, H, n)[0]   # another only to compare them
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk} not in {CHUNKS}")
    y = torch.empty((B, S, H, n), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, n, n), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _kernel_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr() if s0 is not None else None, y.data_ptr(),
        sf.data_ptr(), B, S, H, n, chunk, RKV_DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {err}")
    rwkv6_scan.launches += 1
    return y, sf


# csrc/rwkv6.cu's backward: steps a chunk (L there)
BACKWARD_CHUNK = 16


class BackwardPlan(NamedTuple):
    """How csrc/rwkv6.cu's backward runs a call: ``chunk`` steps a chunk,
    ``cols`` value columns a CTA and ``cluster`` CTAs (the column slices
    of one (batch, head)) a thread-block cluster. The source compiles one
    plan a head dim and refuses any other, so these only check that both
    sides agree."""
    chunk: int
    cols: int
    cluster: int


def plan_backward(B, S, H, n):
    """The backward's plan at (B, S, H, n): chunks of 16 steps, 16 columns
    a CTA, ceil(n / 16) CTAs a cluster, whatever B, S and H."""
    if not 1 <= n <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {n} outside 1..{MAX_HEAD_DIM}")
    if S < 1:
        raise ValueError(f"empty scan: S={S}")
    return BackwardPlan(BACKWARD_CHUNK, COLS_PER_BLOCK,
                        -(-n // COLS_PER_BLOCK))


def backward_scratch_bytes(B, S, H, n):
    """Bytes of the backward's scratch under ``plan_backward``'s plan, for
    each of its B x H x cluster CTAs: a 64 x 16 float32 state slice at
    each chunk's start but the last (the last stays in registers), and
    256 float32 partial sums of du (one a step of a chunk and row the CTA
    owns)."""
    plan = plan_backward(B, S, H, n)
    slices = (-(-S // plan.chunk) - 1) * MAX_HEAD_DIM * plan.cols
    return 4 * B * H * plan.cluster * (slices + plan.chunk * plan.cols)


def _launch_backward(r, k, v, w, u, s0, dy, dsf):
    B, S, H, n = r.shape
    _launch_checks(r, k, v, w, u, s0)
    for name, a in (("dy", dy), ("dsf", dsf)):
        if a is not None and (a.dtype != torch.float32 or a.device != r.device
                              or not a.is_contiguous()):
            raise TypeError(f"the CUDA RWKV6 backward takes a contiguous "
                            f"float32 {name} on r's device; got {a.dtype} "
                            f"on {a.device}")
    dev = r.device
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((B, S, H, n), dtype=torch.float32, device=dev)
    du = torch.empty((H, n), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, n, n), dtype=torch.float32, device=dev)
    plan = plan_backward(B, S, H, n)
    scratch = torch.empty(backward_scratch_bytes(B, S, H, n) // 4,
                          dtype=torch.float32, device=dev)
    ptr = lambda a: a.data_ptr() if a is not None else None  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _backward_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ptr(s0), dy.data_ptr(), ptr(dsf), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
        scratch.data_ptr(), B, S, H, n, RKV_DTYPES[r.dtype], plan.chunk,
        plan.cols, plan.cluster, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    rwkv6_scan_backward.launches += 1
    return dr, dk, dv, dw, du, ds0


def rwkv6_scan_backward(r, k, v, w, u, s0, dy, dsf):
    """The scan's backward: (dr, dk, dv in r's dtype, dw (B, S, H, n),
    du (H, n), ds0 (B, H, n, n) float32) from the forward's inputs, dy
    (B, S, H, n) float32 and dsf (B, H, n, n) float32 or None (zeros).
    CUDA tensors launch the kernel; CPU and meta tensors take
    ``rwkv6_scan_backward_plain``."""
    refuse_dtensor("rwkv6_scan_backward", r, k, v, w, u, s0, dy, dsf)
    rwkv6_scan_backward.calls += 1
    if r.device.type in ("cpu", "meta"):
        out = rwkv6_scan_backward_plain(r, k, v, w, u, s0, dy, dsf)
        return tuple(g.to(r.dtype) for g in out[:3]) + out[3:]
    if r.device.type == "cuda":
        return _launch_backward(r, k, v, w, u, s0, dy.contiguous(),
                                None if dsf is None else dsf.contiguous())
    raise ValueError(f"no rwkv6_scan_backward for device {r.device}")


rwkv6_scan_backward.launches = 0
rwkv6_scan_backward.calls = 0


class RWKV6Scan(torch.autograd.Function):
    """The scan with its backward: ``_scan`` forward, ``rwkv6_scan_
    backward`` backward, on the inputs' device."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return _scan(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, dsf):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_backward(r, k, v, w, u, s0, dy,
                                                      dsf)
        return dr, dk, dv, dw, du, ds0 if s0 is not None else None


def _scan(r, k, v, w, u, s0):
    if r.device.type in ("cpu", "meta"):
        return rwkv6_scan_plain(r, k, v, w, u, s0)
    if r.device.type == "cuda":
        return _launch(r, k, v, w, u, s0)
    raise ValueError(f"no rwkv6_scan for device {r.device}")


def rwkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w: (B, S, H, n); u: (H, n); s0: (B, H, n, n) or None; r, k
    and v float32, bfloat16 or float16, w, u and s0 float32.
    Returns (y (B, S, H, n) float32, final_state (B, H, n, n) float32).
    CUDA tensors launch the kernel; CPU and meta tensors take
    ``rwkv6_scan_plain``.
    Under grad mode with an input that requires grad, through
    ``RWKV6Scan``, whose backward is ``rwkv6_scan_backward``."""
    refuse_dtensor("rwkv6_scan", r, k, v, w, u, s0)
    B, S, H, n = r.shape
    rwkv6_scan.calls += 1
    for name, a in (("k", k), ("v", v), ("w", w)):
        if a.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(a.shape)} != r shape "
                             f"{tuple(r.shape)}")
    if u.shape != (H, n):
        raise ValueError(f"u shape {tuple(u.shape)} != ({H}, {n})")
    if s0 is not None and s0.shape != (B, H, n, n):
        raise ValueError(f"s0 shape {tuple(s0.shape)} != ({B}, {H}, {n}, {n})")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (r, k, v, w, u, s0)):
        return RWKV6Scan.apply(r, k, v, w, u, s0)
    return _scan(r, k, v, w, u, s0)


rwkv6_scan.launches = 0
rwkv6_scan.calls = 0
