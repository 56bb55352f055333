"""PyTorch/CUDA port of the EMSNet + EMSServe system.

Laid out module for module like the JAX package ``repro`` (the
reference), with ``csrc/`` holding the CUDA kernels that replace its
Pallas TPU kernels. Imports ``torch`` and never ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
