"""Public surface of the port's kernels.

Each name here is the kernel's own wrapper (launch counter included):
the hand-written CUDA kernel on CUDA tensors, its plain PyTorch version
on CPU tensors. The Pallas package's other ops (int8 quantize/GEMM,
decode attention, the RWKV6 scan) join as their slices are ported.
"""
from .flash_attention import flash_attention  # noqa: F401
