"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on. Asking for CUDA on a
    machine without a card raises: the port never carries on quietly on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        # float32 products stay float32: the parity tolerances against the
        # JAX reference assume it, and TF32 keeps only ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bfloat16 products accumulate in float32 all the way, as on the
        # CPU, so the bf16 parity tolerances hold on the card too
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
