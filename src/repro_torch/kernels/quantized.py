"""int8 symmetric per-channel quantization and the fused int8 GEMM: the
hand-written CUDA kernels and their plain PyTorch versions.

Ports of the Pallas TPU kernels of ``repro/kernels/quantized.py``:

  * ``quantize_rowwise`` — per-row symmetric int8:
    ``scale[m] = max_k |x[m, k]| / 127`` (1.0 for an all-zero row),
    ``q = clip(round(x / scale), -127, 127)`` with round half to even
    (``jnp.round``), so ``|dequant(quant(x)) - x| <= scale / 2``;
  * ``dequantize_rowwise`` — ``q.float() * scale``;
  * ``int8_matmul`` — ``out[m, n] = (float(acc) * sx[m]) * sw[n]`` with
    ``acc = sum_k xq[m, k] * wq[k, n]`` exact in int32, for
    ``K <= MAX_K``.

On a CUDA tensor each wrapper launches its kernel from
``csrc/quantized.cu`` (built with ``nvcc`` for ``sm_90a`` at first use)
or raises; on a CPU tensor it computes the same function with the plain
version. The plain versions divide by tensors (never by a Python scalar,
which PyTorch's CUDA division turns into a multiply by the reciprocal)
and accumulate the GEMM in float64, exact because
``K * 127**2 < 2**31 < 2**53``, so kernel and plain version agree bit for
bit on the card.

Each wrapper counts ``calls`` (every call, on any device) and
``launches`` (kernel launches only), so a run can show that its int8
path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

# int32 accumulator headroom: K * 127 * 127 must stay below 2^31
MAX_K = (1 << 31) // (127 * 127)


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
    "repro_quantize_rowwise": [_P, _P, _P, _I, _I, _LL, _LL, _P],
    "repro_dequantize_rowwise": [_P, _P, _P, _I, _I, _P],
    "repro_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _kernel_fn(name):
    """A C entry point of csrc/quantized.cu, typed once."""
    from . import build
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 kernels for device {dev}")
    return dev


# ---------------------------------------------------------------- wrappers

def quantize_rowwise(x):
    """x (M, K) float32 -> (q int8 (M, K) contiguous, scale float32
    (M, 1)). The CUDA kernel reads ``x`` through its strides, so a
    transposed view quantizes without a copy."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rowwise takes (M, K), got {tuple(x.shape)}")
    quantize_rowwise.calls += 1
    if _device_of(x).type == "cpu":
        return quantize_rowwise_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA quantize kernel takes float32, got {x.dtype}")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, scale
    _check(_kernel_fn("repro_quantize_rowwise")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K,
        x.stride(0), x.stride(1), _stream(x)), "quantize_rowwise")
    quantize_rowwise.launches += 1
    return q, scale


def dequantize_rowwise(q, scale):
    """(q int8 (M, K), scale float32 (M, 1)) -> float32 (M, K)."""
    if q.dim() != 2 or tuple(scale.shape) != (q.shape[0], 1):
        raise ValueError(f"dequantize_rowwise takes (M, K) and (M, 1), got "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    dequantize_rowwise.calls += 1
    if _device_of(q, scale).type == "cpu":
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
    int8_matmul.calls += 1
    if _device_of(xq, sx, wq, sw).type == "cpu":
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
    _check(_kernel_fn("repro_int8_matmul")(
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        out.data_ptr(), M, K, N, _stream(xq)), "int8_matmul")
    int8_matmul.launches += 1
    return out


for _fn in (quantize_rowwise, dequantize_rowwise, int8_matmul):
    _fn.calls = 0
    _fn.launches = 0
