"""Dense ray/triangle intersection: CUDA kernels and their plain versions.

``tri_intersect`` (nearest hit) and ``tri_occluded`` (any hit within a
distance) replace the Pallas TPU kernels
``tuturenderer_tpu/ops/pallas/intersect.py::_kernel_woop`` and
``::_kernel_woop_anyhit``. On a CUDA tensor each launches its kernel from
``csrc/dense_intersect.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version beside it (``tri_intersect_plain``,
``tri_occluded_plain``), which is also the kernels' oracle on the card.

The table is the flat float32 [T * 13] Woop layout of
``pack_triangles_woop``. ``LAUNCHES`` counts the kernel launches, one per
call that reaches a kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32_MAX = 3.4e38
PARALLEL_EPS = 1e-4     # FLOAT_EQUAL threshold, global.hpp:134-136
TRI_FLOATS = 13
MAX_TRIS = 4096         # dense limit; larger scenes take cluster tables
CHUNK = 512             # triangles per [N, C] tile of the plain versions

# launches per kernel, the cluster kernels' (ops/cuda/cluster.py) included
LAUNCHES = {"nearest": 0, "anyhit": 0, "cluster_nearest": 0,
            "cluster_anyhit": 0, "cluster_transmit": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def pack_triangles_woop(scene) -> torch.Tensor:
    """Flat [T*13] Woop table (r1 c1 r2 c2 r3 c3 nlen per triangle) from
    the scene's prefactored inverse-basis rows."""
    t = scene.woop_nlen.shape[0]
    # woop_w[k, 3i+j] = rows[i, j, k] -> [T, 3, 3] in (i, j, k)
    rows = scene.woop_w.reshape(3, t, 3).permute(1, 2, 0)
    c = scene.woop_c.reshape(t, 3)
    packed = torch.cat([rows, c[:, :, None]], dim=2).reshape(t, 12)
    return torch.cat([packed, scene.woop_nlen[:, None]], dim=1).reshape(-1)


def _check(table, cols) -> int:
    """Validate the kernels' inputs; returns the triangle count."""
    n = cols[0].shape[0] if cols[0].dim() == 1 else -1
    for a in (table, *cols):
        if a.dtype != torch.float32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError("expected contiguous 1-D float32 tensors, got "
                             f"{a.dtype} of shape {tuple(a.shape)}")
        if a.device != table.device:
            raise ValueError(f"tensors on {a.device} and {table.device}")
    if any(c.shape[0] != n for c in cols):
        raise ValueError("ray columns differ in length")
    n_tris, rem = divmod(table.shape[0], TRI_FLOATS)
    if rem:
        raise ValueError(f"table length {table.shape[0]} is not 13 * T")
    if n_tris >= MAX_TRIS:
        raise ValueError(f"{n_tris} triangles: the dense kernels take "
                         f"fewer than {MAX_TRIS}")
    return n_tris


def _lib():
    lib = build.load("dense_intersect")
    if lib.woop_nearest.argtypes is None:
        lib.woop_nearest.argtypes = [_P, _I] + [_P] * 6 + [_I] + [_P] * 5
        lib.woop_nearest.restype = _I
        lib.woop_anyhit.argtypes = [_P, _I] + [_P] * 7 + [_I] + [_P] * 2
        lib.woop_anyhit.restype = _I
    return lib


def _device_of(a: torch.Tensor) -> str:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dense intersection kernel for {a.device}")
    return a.device.type


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def tri_intersect(table, ox, oy, oz, dx, dy, dz):
    """Nearest triangle hit per ray -> (t, idx, bu, bv), [N] each;
    t = 3.4e38 and idx = -1 (int32) on a miss."""
    n_tris = _check(table, (ox, oy, oz, dx, dy, dz))
    if _device_of(ox) == "cpu":
        return tri_intersect_plain(table, ox, oy, oz, dx, dy, dz)
    n = ox.shape[0]
    t = torch.empty_like(ox)
    idx = torch.empty(n, dtype=torch.int32, device=ox.device)
    bu = torch.empty_like(ox)
    bv = torch.empty_like(ox)
    if n == 0:
        return t, idx, bu, bv
    lib = _lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.woop_nearest(
            table.data_ptr(), n_tris, ox.data_ptr(), oy.data_ptr(),
            oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), n,
            t.data_ptr(), idx.data_ptr(), bu.data_ptr(), bv.data_ptr(),
            stream)
    _raise_on(err, "woop_nearest")
    LAUNCHES["nearest"] += 1
    return t, idx, bu, bv


def tri_occluded(table, ox, oy, oz, dx, dy, dz, dist):
    """Any triangle hit with t < dist and |t - dist| >= 1e-4 -> bool [N]."""
    n_tris = _check(table, (ox, oy, oz, dx, dy, dz, dist))
    if _device_of(ox) == "cpu":
        return tri_occluded_plain(table, ox, oy, oz, dx, dy, dz, dist)
    n = ox.shape[0]
    hit = torch.empty(n, dtype=torch.int32, device=ox.device)
    if n == 0:
        return hit.bool()
    lib = _lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.woop_anyhit(
            table.data_ptr(), n_tris, ox.data_ptr(), oy.data_ptr(),
            oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
            dist.data_ptr(), n, hit.data_ptr(), stream)
    _raise_on(err, "woop_anyhit")
    LAUNCHES["anyhit"] += 1
    return hit != 0


# ------------------------------------------------------- plain versions

def _woop_tile(tri, ox, oy, oz, dx, dy, dz):
    """Woop test of [N, 1] rays against a [C, 13] table slice -> (t, u, v,
    ok) [N, C], in the kernel's order of operations."""
    r = [tri[:, j][None, :] for j in range(TRI_FLOATS)]
    r1x, r1y, r1z, c1, r2x, r2y, r2z, c2, r3x, r3y, r3z, c3, nlen = r
    w_o = ox * r3x + oy * r3y + oz * r3z - c3
    w_d = dx * r3x + dy * r3y + dz * r3z
    inv = 1.0 / w_d
    t = -w_o * inv
    u = (ox * r1x + oy * r1y + oz * r1z - c1) + \
        t * (dx * r1x + dy * r1y + dz * r1z)
    v = (ox * r2x + oy * r2y + oz * r2z - c2) + \
        t * (dx * r2x + dy * r2y + dz * r2z)
    dn = w_d * nlen
    ok = (dn.abs() >= PARALLEL_EPS) & (t > 0.0) & (u > 0.0) & (v > 0.0) \
        & (1.0 - u - v > 0.0)
    return t, u, v, ok


def tri_intersect_plain(table, ox, oy, oz, dx, dy, dz):
    """Plain PyTorch nearest hit over [N, 512] triangle tiles. The first
    minimum wins within a tile and a strict < across tiles, so an exact t
    tie keeps the lowest index, as in the kernel."""
    tri = table.reshape(-1, TRI_FLOATS)
    n = ox.shape[0]
    t_best = torch.full((n,), F32_MAX, dtype=torch.float32, device=ox.device)
    idx = torch.full((n,), -1, dtype=torch.int32, device=ox.device)
    bu = torch.zeros_like(t_best)
    bv = torch.zeros_like(t_best)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    for lo in range(0, tri.shape[0], CHUNK):
        t, u, v, ok = _woop_tile(tri[lo:lo + CHUNK], *rays)
        t = torch.where(ok, t, F32_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)
        t_min = t.gather(1, j)[:, 0]
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        idx = torch.where(better, (lo + j[:, 0]).to(torch.int32), idx)
        bu = torch.where(better, u.gather(1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(1, j)[:, 0], bv)
    return t_best, idx, bu, bv


def tri_occluded_plain(table, ox, oy, oz, dx, dy, dz, dist):
    """Plain PyTorch any hit within ``dist`` over [N, 512] tiles."""
    tri = table.reshape(-1, TRI_FLOATS)
    blocked = torch.zeros(ox.shape[0], dtype=torch.bool, device=ox.device)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    d = dist[:, None]
    for lo in range(0, tri.shape[0], CHUNK):
        t, _, _, ok = _woop_tile(tri[lo:lo + CHUNK], *rays)
        ok = ok & (t < d) & ((t - d).abs() >= PARALLEL_EPS)
        blocked = blocked | ok.any(dim=1)
    return blocked
