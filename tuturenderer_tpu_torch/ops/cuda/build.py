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

# the kernels every render on the card runs (the RNG's draw, the dense
# intersection queries, the BSDF): the first of them to load builds all
# three, in one nvcc round
RENDER_KERNELS = ("rng", "dense_intersect", "bsdf")

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


def load_all(names) -> dict:
    """The libraries built from ``csrc/<name>.cu`` for each name, compiled
    where needed by one nvcc process per source, all started together.
    Raises if an nvcc fails or a library does not load."""
    todo = [n for n in names if n not in _LIBS and
            not library_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        os.replace(tmp, library_path(name))
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if needed.
    Raises if nvcc fails or the library does not load."""
    return load_all([name])[name]
