"""int8 symmetric per-channel quantization and the fused int8 GEMM: the
hand-written CUDA kernels and their plain PyTorch versions.

Ports of the Pallas TPU kernels of ``repro/kernels/quantized.py``:

  * ``quantize_rowwise`` — per-row symmetric int8:
    ``scale[m] = max_k |x[m, k]| / 127`` (1.0 for an all-zero row),
    ``q = clip(round(x / scale), -127, 127)`` with round half to even
    (``jnp.round``), so ``|dequant(quant(x)) - x| <= scale / 2``; ``x``
    in float32, bfloat16 or float16, each element up-cast exactly to
    float32 first, as the Pallas body casts it;
  * ``dequantize_rowwise`` — ``q.float() * scale``;
  * ``int8_matmul`` — ``out[m, n] = (float(acc) * sx[m]) * sw[n]`` with
    ``acc = sum_k xq[m, k] * wq[k, n]`` exact in int32, for
    ``K <= MAX_K``.

On a CUDA tensor each wrapper launches its kernel from
``csrc/quantized.cu`` (built with ``nvcc`` for ``sm_90a`` at first use)
as its plan says, or raises; on a CPU tensor it computes the same
function with the plain version, as it does on a ``meta`` tensor (the
dry run's shapes).

  * ``plan_quantize`` picks the quantize kernel's form from the view's
    strides: ``rows`` (1-8 warps a row, every load of the row in flight
    at once and held in registers, 4 elements a load where the row starts
    on their 16 (float32) or 8 (bf16, fp16) bytes, else ``rows_scalar``), ``cols`` (the view ``w.T`` that
    ``quantize_colwise`` passes: 32 columns of ``w`` a block, read 128
    bytes at a time, K split over a thread-block cluster) or ``loop``
    (rows over either form's cap, any other strides).
  * Dequantize is a grid-stride loop, an element a thread.
  * Both launch with programmatic dependent launch (PDL): a launch may be
    scheduled while its predecessor in the stream drains.
  * ``plan_k_splits`` splits the GEMM's K over a cluster (the GEMM runs
    on the int8 tensor cores).

The plain versions divide by tensors (never by a Python scalar, which
PyTorch's CUDA division turns into a multiply by the reciprocal) and
accumulate the GEMM in float64, exact because
``K * 127**2 < 2**31 < 2**53``, so kernel and plain version agree bit for
bit on the card.

Each wrapper counts ``calls`` (every call, on any device) and
``launches`` (kernel launches only), so a run can show that its int8
path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..distributed.spmd import refuse_dtensor
from . import build

# int32 accumulator headroom: K * 127 * 127 must stay below 2^31
MAX_K = (1 << 31) // (127 * 127)
# csrc/quantized.cu's GEMM: output tile (BM = BN), wgmma's depth for
# 8-bit operands, and the cluster size cap of its split-K
GEMM_TILE = 64
K_STEP = 32
MAX_KSPLIT = 8


def plan_k_splits(M, K, N):
    """``(ksplit, kchunk)``: K cut into ksplit contiguous chunks of
    ``kchunk`` (a multiple of K_STEP; the last chunk may be shorter, none
    is empty), so that ``ceil(M / 64) * ceil(N / 64) * ksplit`` blocks come
    to about one wave of the card, with ``ksplit <= MAX_KSPLIT`` (one
    cluster sums the chunks)."""
    tiles = -(-M // GEMM_TILE) * -(-N // GEMM_TILE)
    steps = max(1, -(-K // K_STEP))
    want = max(1, min(MAX_KSPLIT, steps, build.SMS // max(1, tiles)))
    chunk = -(-steps // want)
    return -(-steps // chunk), chunk * K_STEP


# csrc/quantized.cu's quantize kernel
MAX_WARPS = 8              # warps a block of the rows and loop forms
ROWS_VECS = 2              # rows form: 4-element slots a thread at most
ROWS_CAP = 4 * 32 * MAX_WARPS * ROWS_VECS
ROWS_AIM = 1               # rows form: 4-element slots a thread the plan aims for
COL_WARPS = 16             # cols form: warps a block, unless K needs more
COL_MAX_WARPS = 32
COL_DEPTHS = (1, 4, 8, 12)  # cols form: rows of w a lane
COL_TILE = COL_MAX_WARPS * COL_DEPTHS[-1]   # cols form: rows of w a block
COLS_CAP = MAX_KSPLIT * COL_TILE
LOOP_UNROLL = 8            # loop form: loads in flight a thread
QUANTIZE_FORMS = ("rows", "rows_scalar", "cols", "loop")
# the input types the quantize kernel loads, by its dtype code
QUANTIZE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class QuantizePlan(NamedTuple):
    form: str              # one of QUANTIZE_FORMS
    depth: int             # rows: 4-element slots a thread; cols: rows of w a lane
    warps: int             # warps a block
    tpr: int               # rows, loop: threads a row (a multiple of 32)
    grid: tuple            # (x, y): y splits K over the cols form's cluster
    kchunk: int            # cols: rows of w a block of the cluster takes


def _rows_a_block(M):
    """Rows a block for a warp-a-row kernel: one while the rows fit one
    wave of the card, then enough to keep the grid at about one wave."""
    return 1 if M <= build.SMS else min(MAX_WARPS, -(-M // build.SMS))


def _row_plan(form, M, tpr, depth):
    rows = _rows_a_block(M) if tpr == 32 else 1
    return QuantizePlan(form, depth, rows * tpr // 32, tpr, (-(-M // rows), 1),
                        0)


def plan_quantize(M, K, x_sm, x_sk, aligned):
    """How ``csrc/quantized.cu`` quantizes an (M, K) view with element
    strides ``(x_sm, x_sk)``; ``aligned`` says that each row starts on 4
    elements' bytes (``_aligned``: the base so aligned and
    ``x_sm % 4 == 0``, or one row). The plan is the same for every input
    type.

    * ``rows`` / ``rows_scalar`` (``x_sk == 1``, ``K <= ROWS_CAP``): a
      row takes enough warps (up to MAX_WARPS) that each thread holds
      about ROWS_AIM 4-element slots (3 warps at K = 312, 8 at K = 1200);
      rows of one warp pack into blocks only past one wave of rows.
    * ``cols`` (``x_sm == 1``, the view ``w.T``, ``K <= COLS_CAP``): 32
      columns of w a block of COL_WARPS warps (more where K needs them),
      K split over a cluster of up to MAX_KSPLIT blocks, toward one wave
      of the card, in chunks of at least 64 rows of w.
    * ``loop``: everything else, with 1-8 warps a row."""
    if (x_sk == 1 or K <= 1) and K <= ROWS_CAP:
        tpr = 32 * min(MAX_WARPS, max(1, -(-K // (4 * 32 * ROWS_AIM))))
        return _row_plan("rows" if aligned else "rows_scalar", M, tpr,
                         max(1, -(-K // (4 * tpr))))
    if x_sm == 1 and x_sk != 1 and M > 1 and K <= COLS_CAP:
        groups = -(-M // 32)
        # a lane holds at most COL_DEPTHS[-1] rows of w, so a block of
        # ``warps`` takes at most warps * COL_DEPTHS[-1] <= COL_TILE
        warps = max(COL_WARPS, -(-K // (MAX_KSPLIT * COL_DEPTHS[-1])))
        want = max(min(MAX_KSPLIT, build.SMS // groups, -(-K // 64)),
                   -(-K // (warps * COL_DEPTHS[-1])), 1)
        kchunk = -(-K // want)
        kchunk += -kchunk % 4
        depth = next(d for d in COL_DEPTHS if warps * d >= kchunk)
        return QuantizePlan("cols", depth, warps, 0, (groups, -(-K // kchunk)),
                            kchunk)
    tpr = 32 * min(MAX_WARPS, max(1, -(-K // (32 * LOOP_UNROLL * 4))))
    return _row_plan("loop", M, tpr, 0)


# ---------------------------------------------------------------- plain

def quantize_rowwise_plain(x):
    """x (M, K) float -> (q int8 (M, K), scale float32 (M, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True) if xf.shape[1] else \
        torch.zeros((xf.shape[0], 1), device=xf.device)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_rowwise_plain(q, scale):
    """(q int8 (M, K), scale (M, 1)) -> float32 (M, K)."""
    return q.float() * scale.float()


def int8_matmul_plain(xq, sx, wq, sw):
    """The int8 GEMM with exact accumulation (float64 holds every partial
    sum exactly below MAX_K), then ``(float(acc) * sx) * sw``."""
    acc = xq.double() @ wq.double()
    return acc.float() * sx.float() * sw.float()


# ---------------------------------------------------------------- kernels

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_quantize_rowwise": [_P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P],
    "repro_dequantize_rowwise": [_P, _P, _P, _I, _I, _P],
    "repro_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _kernel_fn(name):
    """A C entry point of csrc/quantized.cu, typed once."""
    fn = getattr(build.library("quantized"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _device_of(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all operands must be on one device")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no int8 kernels for device {dev}")
    return dev


# ---------------------------------------------------------------- wrappers

def _aligned(x):
    """Every row of the view x starts on 4 elements' bytes (16 for
    float32, 8 for bf16 and fp16): the rows form's one-load slots."""
    return (x.data_ptr() % (4 * x.element_size()) == 0
            and (x.stride(0) % 4 == 0 or x.shape[0] == 1))


def quantize_rowwise(x):
    """x (M, K) float32, bfloat16 or float16 -> (q int8 (M, K)
    contiguous, scale float32 (M, 1)). The CUDA kernel reads ``x``
    through its strides, so a transposed view quantizes without a copy,
    and converts each element to float32 as it loads it."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rowwise takes (M, K), got {tuple(x.shape)}")
    refuse_dtensor("quantize_rowwise", x)
    quantize_rowwise.calls += 1
    if _device_of(x).type in ("cpu", "meta"):
        return quantize_rowwise_plain(x)
    if x.dtype not in QUANTIZE_DTYPES:
        raise TypeError(f"the CUDA quantize kernel takes float32, bfloat16 "
                        f"or float16, got {x.dtype}")
    if x.shape[0] == 0:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty((0, 1), dtype=torch.float32, device=x.device))
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    plan = plan_quantize(M, K, x.stride(0), x.stride(1), _aligned(x))
    _check(_kernel_fn("repro_quantize_rowwise")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K, x.stride(0),
        x.stride(1), QUANTIZE_FORMS.index(plan.form), plan.depth, plan.warps,
        plan.tpr, plan.grid[0], plan.grid[1], plan.kchunk,
        QUANTIZE_DTYPES[x.dtype], _stream(x)),
        "quantize_rowwise")
    quantize_rowwise.launches += 1
    return q, scale


def dequantize_rowwise(q, scale):
    """(q int8 (M, K), scale float32 (M, 1)) -> float32 (M, K)."""
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0], 1):
        raise ValueError(f"dequantize_rowwise takes (M, K) and (M, 1), got "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    refuse_dtensor("dequantize_rowwise", q, scale)
    dequantize_rowwise.calls += 1
    if _device_of(q, scale).type in ("cpu", "meta"):
        return dequantize_rowwise_plain(q, scale)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"the CUDA dequantize kernel takes int8 and float32, "
                        f"got {q.dtype} and {scale.dtype}")
    q, scale = q.contiguous(), scale.contiguous()
    M, K = q.shape
    out = torch.empty((M, K), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    _check(_kernel_fn("repro_dequantize_rowwise")(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, _stream(q)),
        "dequantize_rowwise")
    dequantize_rowwise.launches += 1
    return out


def int8_matmul(xq, sx, wq, sw):
    """Fused quantized GEMM. xq (M, K) int8, sx (M, 1) float32 row scales,
    wq (K, N) int8, sw (1, N) float32 output-channel scales -> (M, N)
    float32 ``(xq @ wq) * sx * sw``. The CUDA path takes contiguous
    operands only (``quantize_colwise`` derives ``wq`` contiguous)."""
    M, K = xq.shape
    K2, N = wq.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(xq.shape)} x "
                         f"{tuple(wq.shape)}")
    if K > MAX_K:
        raise ValueError(f"K={K} overflows the int32 accumulator "
                         f"(max {MAX_K})")
    if tuple(sx.shape) != (M, 1) or tuple(sw.shape) != (1, N):
        raise ValueError(f"scales must be ({M}, 1) and (1, {N}), got "
                         f"{tuple(sx.shape)} and {tuple(sw.shape)}")
    refuse_dtensor("int8_matmul", xq, sx, wq, sw)
    int8_matmul.calls += 1
    if _device_of(xq, sx, wq, sw).type in ("cpu", "meta"):
        return int8_matmul_plain(xq, sx, wq, sw)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or \
            sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("the CUDA int8 GEMM takes int8 xq/wq and float32 "
                        "sx/sw")
    if not all(t.is_contiguous() for t in (xq, sx, wq, sw)):
        raise ValueError("the CUDA int8 GEMM takes contiguous operands")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if out.numel() == 0:
        return out
    ksplit, kchunk = plan_k_splits(M, K, N)
    _check(_kernel_fn("repro_int8_matmul")(
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        out.data_ptr(), M, K, N, ksplit, kchunk, _stream(xq)), "int8_matmul")
    int8_matmul.launches += 1
    return out


for _fn in (quantize_rowwise, dequantize_rowwise, int8_matmul):
    _fn.calls = 0
    _fn.launches = 0
