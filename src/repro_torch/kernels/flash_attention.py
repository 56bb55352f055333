"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

``flash_attention`` is the port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``, all modes:
``kv_lengths`` key padding, ``segment_ids`` (the packed ragged layout),
causal with ``q_offset = Sk - Sq``, a sliding ``window`` and GQA, with
q, k and v in float32, bfloat16 or float16: like the Pallas body, it
sums in float32 and returns q's dtype. On a CUDA tensor it launches
``csrc/flash_attention.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use) or raises: float32 on the FMA units, bf16 and fp16 on the tensor
cores with float32 accumulators. On a CPU tensor it computes the same
function with ``flash_attention_plain``. Nothing falls back from one to
the other.

``flash_attention.launches`` counts kernel launches, so a run can show
that its attention went through the kernel; ``flash_attention.calls``
counts every call on any device, so a CPU run gives the count a card run
must launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
# csrc/flash_attention.cu: query rows a block can take (16 or 64 on 4
# warps of 1 or 4 rows a lane; 128 on 8 warps of 4, below head dim 128)
# and the head-dim paddings it compiles
BLOCK_Q = (16, 64, 128)
HEAD_PADS = (32, 64, 128)
SMALL_GRID_WAVES = 4
# the input types the kernel loads (q, k and v alike), by its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# bf16 and fp16 run on the tensor-core kernel: 16 query rows a warp, 64
# rows on 4 warps
HALF_BLOCK_Q = (64,)


def plan_tiles(B, Sq, Sk, H, D, dtype=torch.float32):
    """``(block_q, head_pad)`` for the CUDA kernel: the head dim padded to
    the next of ``HEAD_PADS``, and the query rows a block.

    float32 (the FMA kernel): while a grid of 16-row blocks is at most
    ``SMALL_GRID_WAVES`` waves of the card (the per-event encodes, the
    packed ragged buffer), 16 rows: the most blocks, each with the
    shortest chain. Above that, the largest block that Sq fills, so each
    staged K/V tile serves the most queries: 128 rows on 8 warps (head
    dims up to 64), else 64.

    bf16 and fp16 (the tensor-core kernel, ``HALF_BLOCK_Q``): 64 rows on
    4 warps, 16 a warp, at every shape.

    Sk does not enter: every plan walks the keys in 64-key tiles."""
    head_pad = next((p for p in HEAD_PADS if D <= p), None)
    if head_pad is None:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if dtype != torch.float32:
        return HALF_BLOCK_Q[0], head_pad
    if B * H * -(-Sq // 16) <= SMALL_GRID_WAVES * build.SMS:
        return 16, head_pad
    for block_q in (128, 64):
        if block_q <= Sq and (block_q < 128 or head_pad < 128):
            return block_q, head_pad
    return 16, head_pad


def attention_mask(B, Sq, Sk, *, causal=False, window=0, kv_lengths=None,
                   segment_ids=None, device=None):
    """Boolean (B, Sq, Sk) mask of the (query, key) pairs that attend."""
    q_pos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq if causal else 0)
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= q_pos - k_pos < window
    mask = mask.expand(B, Sq, Sk)
    if kv_lengths is not None:
        mask = mask & (k_pos[None] < kv_lengths.to(device)[:, None, None])
    if segment_ids is not None:
        seg = segment_ids.to(device)
        mask = mask & ((seg[:, :, None] == seg[:, None, :])
                       & (seg >= 0)[:, None, :])
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          kv_lengths=None, segment_ids=None):
    """Materialised masked softmax attention, as ``kernels/ref.py::
    attention_ref`` computes it, plus the segment mode. q: (B, Sq, H, D);
    k, v: (B, Sk, KV, D/Dv). Rows whose keys are all masked give 0."""
    B, Sq, H, D = q.shape
    _, Sk, KV, Dv = v.shape
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(B, Sq, Sk, causal=causal, window=window,
                          kv_lengths=kv_lengths, segment_ids=segment_ids,
                          device=q.device)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.where(mask, torch.softmax(s, dim=-1), torch.zeros_like(s))
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _kernel_fn():
    """The C entry point of csrc/flash_attention.cu, typed once (ctypes
    keeps one function object per library attribute)."""
    fn = build.library("flash_attention").repro_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 6 + [i] * 7 + [ll] * 10
                       + [ctypes.c_float, i, i, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, *, causal, window, scale, kv_lengths, segment_ids,
            block_q=None):
    B, Sq, H, D = q.shape
    _, Sk, KV, Dv = v.shape
    if not (q.dtype == k.dtype == v.dtype and q.dtype in DTYPES):
        raise TypeError(f"the CUDA flash kernel takes q/k/v of one dtype, "
                        f"float32, bfloat16 or float16; got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dim {max(D, Dv)} > {MAX_HEAD_DIM}: the CUDA "
                         "flash kernel pads head dims to 32/64/128")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the head dim")
    planned, head_pad = plan_tiles(B, Sq, Sk, H, max(D, Dv), q.dtype)
    block_q = block_q or planned           # another plan only to compare them
    allowed = BLOCK_Q if q.dtype == torch.float32 else HALF_BLOCK_Q
    if block_q not in allowed:
        raise ValueError(f"block_q={block_q} not in {allowed} for "
                         f"{q.dtype}")
    if -(-Sq // block_q) > 65535:
        raise ValueError(f"Sq={Sq} exceeds the kernel's grid")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lens = seg = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (B,):
            raise ValueError(f"kv_lengths shape {tuple(lens.shape)} != ({B},)")
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if seg.shape != (B, Sq):
            raise ValueError(f"segment_ids shape {tuple(seg.shape)} != "
                             f"({B}, {Sq})")
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        seg.data_ptr() if seg is not None else None,
        B, Sq, Sk, H, KV, D, Dv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        seg.stride(0) if seg is not None else 0,
        float(scale), int(causal), int(window), (Sk - Sq) if causal else 0,
        block_q, head_pad, DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    kv_lengths=None, segment_ids=None, block_q=128,
                    block_k=128):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D/Dv). Returns (B, Sq, H, Dv).

    ``kv_lengths`` (B,) masks keys at or past each row's length; a
    zero-length row gives exactly 0. ``segment_ids`` (B, S), with
    Sq == Sk: a query attends a key iff their ids are equal and the key's
    id is >= 0, so a -1 query row gives exactly 0. In segment mode S is
    padded up to a multiple of ``block_q`` and ``block_k`` with id -1
    before the mask is applied, as the Pallas wrapper does; elsewhere the
    block sizes are the CUDA kernel's own and these arguments are unused.
    The padding never changes the result.

    CUDA tensors launch the kernel (float32, bfloat16 or float16, the
    three alike; head dims up to 128); CPU tensors take
    ``flash_attention_plain``. Either way the softmax and the sums are
    float32 and the output has q's dtype.

    The kernel has no backward (nor has the Pallas kernel it ports), so a
    call under grad mode with any of q, k, v requiring grad raises, on
    both devices alike: the CPU sees what the card would do. Training
    runs the materialised attention (``use_flash_text=False``); serving
    runs under ``torch.inference_mode()``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (neither the CUDA kernel nor "
            "the reference's Pallas kernel): call it under torch.no_grad() "
            "or torch.inference_mode(), or train with "
            "use_flash_text=False")
    flash_attention.calls += 1
    if causal and (kv_lengths is not None or segment_ids is not None):
        raise NotImplementedError(
            "kv_lengths/segment_ids require causal=False (per-row causal "
            "alignment is not implemented)")
    if kv_lengths is not None and segment_ids is not None:
        raise ValueError("kv_lengths and segment_ids are mutually exclusive")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = v.shape
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if segment_ids is not None and Sq != Sk:
        raise ValueError("segment_ids requires Sq == Sk (self-attention "
                         "over one packed buffer)")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    S = Sq
    if segment_ids is not None:
        pad = (-S) % math.lcm(block_q, block_k)
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (q, k, v))
            segment_ids = torch.nn.functional.pad(segment_ids, (0, pad),
                                                  value=-1)
    kw = dict(causal=causal, window=window, scale=scale,
              kv_lengths=kv_lengths, segment_ids=segment_ids)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, **kw)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, **kw)
    else:
        raise ValueError(f"no flash_attention for device {q.device}")
    return out[:, :S]


flash_attention.calls = 0
flash_attention.launches = 0
