"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes,
strides, the stream) and compiles on its own into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository
root, for ``sm_90a``. The hash covers the source and the flags, so an
edited source builds anew and an unchanged one is loaded from disk. No
PyTorch header is included, so a build takes seconds, not minutes.

Building happens at first use, never at import: the CPU tests import
every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SMS = 132          # streaming multiprocessors of the H100 SXM: one wave of blocks

_loaded: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "cached",
    "ptxas"}}``; raises ``RuntimeError`` with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, report = {}, {}
    for src in sources():
        out = _target(src)
        if out.exists():
            report[src.stem] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)               # atomic: concurrent builds agree
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": log}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(CSRC / f"{name}.cu")
        if not out.exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(out))
    return lib
