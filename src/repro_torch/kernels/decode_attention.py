"""One-token decode attention against a ring-buffer KV cache: the
hand-written CUDA kernel and its plain PyTorch version.

``decode_attention`` is the port of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. It computes
what that kernel's oracle, ``repro/models/attention.py::
plain_attention_vs_cache``, computes: the G = H / KV grouped query heads
of one new token attend to the W slots of a (B, W, KV, D) cache; slot j
is valid iff ``0 <= slot_pos[j] <= t`` and, with a window,
``t - slot_pos[j] < window``; invalid slots score -1e30 before the
softmax. A cache with no valid slot therefore gives the plain mean of v
over the W slots, as the oracle does (the Pallas kernel, which pads W to
a block multiple, averages its padded zero slots in too: ROADMAP queue 3).

On a CUDA tensor it launches ``csrc/decode_attention.cu`` (float32 or
bfloat16; built with ``nvcc`` for ``sm_90a`` at first use), which cuts
the W slots into ``plan_splits`` chunks, one block each, merged inside a
thread-block cluster; or it raises. On
a CPU tensor it computes ``decode_attention_plain``. Nothing falls back
from one to the other. ``t`` may be a Python int or a 0-d integer
tensor; on the card it is read from device memory, so a decode step
never waits for the host.

``decode_attention.launches`` counts kernel launches, so a run can show
that its decode went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/decode_attention.cu: query rows per block (GB) and the cluster size
# cap (MAX_SPLIT; above 8 the cluster is non-portable)
ROWS_PER_BLOCK = 4
MAX_SPLIT = 16


def plan_splits(B, KV, G, W):
    """``(nsplit, chunk)``: the W slots cut into nsplit contiguous chunks
    of ``chunk`` slots (the last one may be shorter, none is empty), so
    that the grid of ``B * KV * ceil(G / ROWS_PER_BLOCK) * nsplit`` blocks
    comes to about one wave of the card, with ``nsplit <= MAX_SPLIT`` (one
    cluster merges the chunks) and ``nsplit <= W``."""
    blocks = B * KV * -(-G // ROWS_PER_BLOCK)
    want = max(1, min(MAX_SPLIT, W, build.SMS // blocks))
    chunk = -(-W // want)
    return -(-W // chunk), chunk


def decode_attention_plain(q, kbuf, vbuf, slot_pos, t, *, window=0,
                           scale=None):
    """q: (B, 1, H, D); kbuf/vbuf: (B, W, KV, D/Dv); slot_pos: (W,) int
    positions stored per slot (-1 = never written); t: the current
    position. Materialised softmax in float32; returns (B, 1, H, Dv) in
    q's dtype."""
    B, _, H, D = q.shape
    KV = kbuf.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kbuf.float()) * scale
    t = torch.as_tensor(t, device=slot_pos.device)
    valid = (slot_pos >= 0) & (slot_pos <= t)
    if window:
        valid &= t - slot_pos < window
    s = s.masked_fill(~valid[None, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, vbuf.float())
    return out.reshape(B, 1, H, vbuf.shape[-1]).to(q.dtype)


def _kernel_fn():
    """The C entry point of csrc/decode_attention.cu, typed once."""
    fn = build.library("decode_attention").repro_decode_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 7 + [ll] * 8 + [ctypes.c_float] + \
            [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, kbuf, vbuf, slot_pos, t, *, window, scale):
    B, _, H, D = q.shape
    _, W, KV, Dv = vbuf.shape
    if not (q.dtype == kbuf.dtype == vbuf.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA decode kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{kbuf.dtype}/"
                        f"{vbuf.dtype}")
    if max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dim {max(D, Dv)} > {MAX_HEAD_DIM}: the CUDA "
                         "decode kernel pads head dims to 32/64/128")
    if any(x.device != q.device for x in (kbuf, vbuf, slot_pos)):
        raise ValueError("q, kbuf, vbuf and slot_pos must be on one device")
    if any(x.stride(-1) != 1 for x in (q, kbuf, vbuf)):
        raise ValueError("q, kbuf and vbuf need a unit stride on the head dim")
    if slot_pos.shape != (W,):
        raise ValueError(f"slot_pos shape {tuple(slot_pos.shape)} != ({W},)")
    pos = slot_pos.to(torch.int32).contiguous()
    t_dev = torch.as_tensor(t).to(device=q.device, dtype=torch.int32)
    if t_dev.dim() != 0:
        raise ValueError(f"t must be a scalar, got shape {tuple(t_dev.shape)}")
    if B * H * W * Dv == 0:
        raise ValueError(f"empty decode: B={B}, H={H}, W={W}, Dv={Dv}")
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    nsplit, chunk = plan_splits(B, KV, H // KV, W)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), out.data_ptr(),
        pos.data_ptr(), t_dev.data_ptr(), _DTYPES[q.dtype],
        B, W, H, KV, D, Dv,
        q.stride(0), q.stride(2),
        kbuf.stride(0), kbuf.stride(1), kbuf.stride(2),
        vbuf.stride(0), vbuf.stride(1), vbuf.stride(2),
        float(scale), int(window), nsplit, chunk, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q, kbuf, vbuf, slot_pos, t, *, window=0, scale=None):
    """q: (B, 1, H, D); kbuf/vbuf: (B, W, KV, D/Dv); slot_pos: (W,) int32;
    t: the current position (int or 0-d tensor). Returns (B, 1, H, Dv) in
    q's dtype. CUDA tensors launch the kernel; CPU tensors take
    ``decode_attention_plain``."""
    B, one, H, D = q.shape
    KV = kbuf.shape[2]
    if one != 1:
        raise ValueError(f"decode attention takes one query token, got {one}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if kbuf.shape[:3] != vbuf.shape[:3]:
        raise ValueError(f"kbuf {tuple(kbuf.shape)} and vbuf "
                         f"{tuple(vbuf.shape)} disagree")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return decode_attention_plain(q, kbuf, vbuf, slot_pos, t,
                                      window=window, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, kbuf, vbuf, slot_pos, t, window=window, scale=scale)
    raise ValueError(f"no decode_attention for device {q.device}")


decode_attention.launches = 0
