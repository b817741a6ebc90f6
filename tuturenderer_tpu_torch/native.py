"""ctypes bindings to the native host runtime (``native/libtutuhost.so``).

The port's own copy of ``tuturenderer_tpu/native.py``'s binding. The
reference's host layer is all C++ (OBJ loader OBJ_Loader.h, BVH build
BVH.hpp:47-123, PPM I/O PPMGenerator.hpp); ``native/host.cpp`` implements
it behind a plain C ABI with no framework in it, so both packages bind the
same library. This is host file I/O, not the device path.

The committed ``native/libtutuhost.so`` is loaded first. If it does not
load (another C library, say), ``native/host.cpp`` is built with g++ into
``build/native/libtutuhost.so`` (gitignored) and that is loaded; nothing
is ever written under ``native/``. Where no library can be had,
``obj_load``, ``bvh_build`` and ``ppm_read`` return None and ``ppm_write``
False, and the callers take their pure-Python paths.
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_ROOT, "native", "host.cpp")
_COMMITTED = os.path.join(_ROOT, "native", "libtutuhost.so")
_BUILT = os.path.join(_ROOT, "build", "native", "libtutuhost.so")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib = None
_tried = False


class _ObjResult(ct.Structure):
    _fields_ = [("verts", ct.POINTER(ct.c_float)),
                ("normals", ct.POINTER(ct.c_float)),
                ("uvs", ct.POINTER(ct.c_float)),
                ("n_tris", ct.c_int64),
                ("ok", ct.c_int32)]


class _BvhResult(ct.Structure):
    _fields_ = [("bb_min", ct.POINTER(ct.c_float)),
                ("bb_max", ct.POINTER(ct.c_float)),
                ("left", ct.POINTER(ct.c_int32)),
                ("right", ct.POINTER(ct.c_int32)),
                ("start", ct.POINTER(ct.c_int32)),
                ("count", ct.POINTER(ct.c_int32)),
                ("prim", ct.POINTER(ct.c_int32)),
                ("n_nodes", ct.c_int64),
                ("n_prims", ct.c_int64)]


class _PpmResult(ct.Structure):
    _fields_ = [("rgb", ct.POINTER(ct.c_float)),
                ("w", ct.c_int32), ("h", ct.c_int32), ("ok", ct.c_int32)]


def _build() -> Optional[str]:
    """Compile native/host.cpp into build/native/; its path, or None."""
    os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", _BUILT, _SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return _BUILT


def _open(path: str) -> Optional[ct.CDLL]:
    try:
        return ct.CDLL(path)
    except OSError:
        return None


def load_library() -> Optional[ct.CDLL]:
    """The native library (the committed one, else one built from
    host.cpp), its functions declared; None if neither can be had."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _open(_COMMITTED)
    if lib is None and os.path.exists(_BUILT):
        lib = _open(_BUILT)
    if lib is None:
        built = _build()
        lib = _open(built) if built else None
    if lib is None:
        return None
    lib.tutu_obj_load.restype = ct.POINTER(_ObjResult)
    lib.tutu_obj_load.argtypes = [ct.c_char_p]
    lib.tutu_obj_result_free.restype = None
    lib.tutu_obj_result_free.argtypes = [ct.POINTER(_ObjResult)]
    lib.tutu_bvh_build.restype = ct.POINTER(_BvhResult)
    lib.tutu_bvh_build.argtypes = [ct.POINTER(ct.c_float), ct.c_int64,
                                   ct.c_int32]
    lib.tutu_bvh_free.restype = None
    lib.tutu_bvh_free.argtypes = [ct.POINTER(_BvhResult)]
    lib.tutu_ppm_write.restype = ct.c_int32
    lib.tutu_ppm_write.argtypes = [ct.c_char_p, ct.POINTER(ct.c_float),
                                   ct.c_int32, ct.c_int32, ct.c_float]
    lib.tutu_ppm_read.restype = ct.POINTER(_PpmResult)
    lib.tutu_ppm_read.argtypes = [ct.c_char_p]
    lib.tutu_ppm_free.restype = None
    lib.tutu_ppm_free.argtypes = [ct.POINTER(_PpmResult)]
    _lib = lib
    return lib


def _as_np(ptr, count, dtype):
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def obj_load(path: str):
    """-> (verts [n,3,3], normals [n,3,3], uvs [n,3,2]) float32, or None
    if no library can be had. A file that cannot be read raises
    FileNotFoundError."""
    lib = load_library()
    if lib is None:
        return None
    res = lib.tutu_obj_load(path.encode())
    try:
        r = res.contents
        if not r.ok:
            raise FileNotFoundError(path)
        n = r.n_tris
        verts = _as_np(r.verts, n * 9, np.float32).reshape(n, 3, 3)
        normals = _as_np(r.normals, n * 9, np.float32).reshape(n, 3, 3)
        uvs = _as_np(r.uvs, n * 6, np.float32).reshape(n, 3, 2)
        return verts, normals, uvs
    finally:
        lib.tutu_obj_result_free(res)


def bvh_build(verts: np.ndarray, leaf_size: int = 4):
    """-> dict of flat BVH arrays (bb_min, bb_max, left, right, start,
    count, prim), or None if no library can be had. verts [n,3,3]."""
    lib = load_library()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float32)
    if v.ndim != 3 or v.shape[1:] != (3, 3):
        raise ValueError(f"verts must be [n, 3, 3], got {v.shape}")
    res = lib.tutu_bvh_build(v.ctypes.data_as(ct.POINTER(ct.c_float)),
                             v.shape[0], leaf_size)
    try:
        r = res.contents
        m = r.n_nodes
        p = r.n_prims
        return dict(
            bb_min=_as_np(r.bb_min, m * 3, np.float32).reshape(m, 3),
            bb_max=_as_np(r.bb_max, m * 3, np.float32).reshape(m, 3),
            left=_as_np(r.left, m, np.int32),
            right=_as_np(r.right, m, np.int32),
            start=_as_np(r.start, m, np.int32),
            count=_as_np(r.count, m, np.int32),
            prim=_as_np(r.prim, max(p, 1), np.int32)[:p],
        )
    finally:
        lib.tutu_bvh_free(res)


def ppm_write(path: str, rgb: np.ndarray, gamma: float = 0.78) -> bool:
    """Write float [H, W, 3] as P3 with the reference's clamp and gamma;
    False if no library can be had."""
    lib = load_library()
    if lib is None:
        return False
    a = np.ascontiguousarray(rgb, np.float32)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"rgb must be [H, W, 3], got {a.shape}")
    h, w, _ = a.shape
    return bool(lib.tutu_ppm_write(path.encode(),
                                   a.ctypes.data_as(ct.POINTER(ct.c_float)),
                                   w, h, gamma))


def ppm_read(path: str):
    """-> float32 [H, W, 3] in [0, 1], or None if no library can be had."""
    lib = load_library()
    if lib is None:
        return None
    res = lib.tutu_ppm_read(path.encode())
    try:
        r = res.contents
        if not r.ok:
            raise FileNotFoundError(path)
        return _as_np(r.rgb, r.w * r.h * 3, np.float32).reshape(r.h, r.w, 3)
    finally:
        lib.tutu_ppm_free(res)
