"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with nvcc for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout and
loaded with ctypes. The hash covers the source and the flags, so an edit
rebuilds. Nothing is built when this module is imported.

``--fmad=false`` keeps nvcc from contracting a multiply and an add into one
fused operation: each kernel then rounds every step as the plain PyTorch
version does, and the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# name -> loaded library, and name -> (seconds, nvcc output) of the build
# this process ran (absent when the library was already on disk)
_LIBS: dict = {}
BUILD_LOG: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if needed.
    Raises if nvcc fails or the library does not load."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]
