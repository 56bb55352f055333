"""Public surface of the port's kernels.

Each kernel name here is the kernel's own wrapper (counters included):
the hand-written CUDA kernel on CUDA tensors, its plain PyTorch version
on CPU tensors. ``quantize_colwise`` and ``quantized_matmul`` compose the
int8 kernels as ``repro.kernels.ops`` does. Every Pallas kernel of the
JAX package has its counterpart here.
"""
from .decode_attention import decode_attention  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .quantized import (MAX_K, dequantize_rowwise,  # noqa: F401
                        int8_matmul, quantize_rowwise)
from .rwkv6 import rwkv6_scan, rwkv6_scan_backward  # noqa: F401


def quantize_colwise(w):
    """Per-output-channel weight quantization: w (K, N) float32 ->
    (q int8 (K, N) contiguous, scale float32 (1, N)) — the rowwise kernel
    on the view ``w.T``, its (N, K) result laid out once as (K, N) so the
    GEMM reads plain row-major weights."""
    q, s = quantize_rowwise(w.T)
    return q.T.contiguous(), s.reshape(1, -1)


def quantized_matmul(x, wq, sw):
    """float32 activations x pre-quantized int8 weights: rowwise-quantize
    then the fused GEMM. Leading dims of x are flattened into M."""
    lead = x.shape[:-1]
    xq, sx = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    return int8_matmul(xq, sx, wq, sw).reshape(*lead, wq.shape[1])


# every counter a kernel wrapper ticks in Python, as (wrapper, attribute):
# ``graphs.Graphed`` adds a capture's ticks again on each replay
COUNTERS = tuple((fn, attr) for fn in (flash_attention, quantize_rowwise,
                                       dequantize_rowwise, int8_matmul,
                                       decode_attention, rwkv6_scan,
                                       rwkv6_scan_backward)
                 for attr in ("calls", "launches"))
