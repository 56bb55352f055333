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
raises; on a CPU tensor it computes ``rwkv6_scan_plain``. Nothing falls
back from one to the other. ``rwkv6_scan.launches`` counts kernel
launches, ``rwkv6_scan.calls`` every call on any device.
"""
from __future__ import annotations

import ctypes

import torch

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
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,n,n)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _kernel_fn():
    """The C entry point of csrc/rwkv6.cu, typed once."""
    from . import build
    fn = build.library("rwkv6").repro_rwkv6_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, s0, chunk=None):
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


def rwkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w: (B, S, H, n); u: (H, n); s0: (B, H, n, n) or None; r, k
    and v float32, bfloat16 or float16, w, u and s0 float32.
    Returns (y (B, S, H, n) float32, final_state (B, H, n, n) float32).
    CUDA tensors launch the kernel; CPU tensors take ``rwkv6_scan_plain``."""
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
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0)
    if r.device.type == "cuda":
        return _launch(r, k, v, w, u, s0)
    raise ValueError(f"no rwkv6_scan for device {r.device}")


rwkv6_scan.launches = 0
rwkv6_scan.calls = 0
