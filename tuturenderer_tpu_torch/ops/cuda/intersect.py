"""Dense ray/triangle intersection: CUDA kernels and their plain versions.

Two forms of the same contract, each a nearest hit and an any hit within a
distance:

- Woop: ``tri_intersect`` / ``tri_occluded`` replace the Pallas TPU kernels
  ``tuturenderer_tpu/ops/pallas/intersect.py::_kernel_woop`` and
  ``::_kernel_woop_anyhit``, over the flat float32 [T * 13] table of
  ``pack_triangles_woop``;
- Moller-Trumbore (MT): ``tri_intersect_mt`` / ``tri_occluded_mt`` replace
  ``::_kernel`` and ``::_kernel_anyhit`` (the JAX package's
  ``PALLAS_IMPL = "mt"``), over the flat float32 [T * 12] table of
  ``pack_triangles``. The MT kernels read their table as 16-byte
  ``float4``, so ``tri_intersect_mt`` and ``tri_occluded_mt`` refuse a
  table that does not start on a 16-byte boundary (a view at an odd
  offset into a larger tensor). The Woop kernels take a table at any
  float offset.

On a CUDA tensor each wrapper launches its kernel from
``csrc/dense_intersect.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version beside it (``*_plain``), which is also the kernels' oracle
on the card. A wrapper refuses rays that require grad: the kernels have no
backward, so a gradient must never reach their raw pointers.
``LAUNCHES`` counts the kernel launches, one per call that reaches a
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32_MAX = 3.4e38
PARALLEL_EPS = 1e-4     # FLOAT_EQUAL threshold, global.hpp:134-136
TRI_FLOATS = 13         # a Woop table row
MT_FLOATS = 12          # an MT table row
MAX_TRIS = 4096         # dense limit; larger scenes take cluster tables
CHUNK = 512             # triangles per [N, C] tile of the plain versions

# launches per kernel, the cluster kernels' (ops/cuda/cluster.py) and the
# visit-walk probe's (tools/proto_visit.py) included
LAUNCHES = {"nearest": 0, "anyhit": 0, "mt_nearest": 0, "mt_anyhit": 0,
            "cluster_nearest": 0, "cluster_anyhit": 0, "cluster_transmit": 0,
            "proto_visit": 0}

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


def pack_triangles(scene) -> torch.Tensor:
    """Flat [T*12] MT table (v0 e1 e2 n_hat per triangle), in float32 on
    the scene's device as ``ops/pallas/intersect.py::pack_triangles``
    computes it: e1 = v1 - v0, e2 = v2 - v0, n = e1 x e2,
    n_hat = n * (1 / max(|n|, 1e-30))."""
    e1 = scene.tv1 - scene.tv0
    e2 = scene.tv2 - scene.tv0
    n = e1.cross(e2)
    nu = n * (1.0 / torch.clamp(n.norm(), min=1e-30))
    return torch.stack([*scene.tv0, *e1, *e2, *nu], dim=1).reshape(-1)


def refuse_grad(cols):
    """Raise on a tensor that requires grad: the kernels have no backward,
    so a gradient would be dropped silently at the raw pointer."""
    if any(c.requires_grad for c in cols):
        raise ValueError("a ray column requires grad: detach the rays at "
                         "the kernel boundary (the kernels have no backward)")


def _check(table, cols, floats: int = TRI_FLOATS) -> int:
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
    refuse_grad((table, *cols))
    n_tris, rem = divmod(table.shape[0], floats)
    if rem:
        raise ValueError(f"table length {table.shape[0]} is not {floats} * T")
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
        lib.mt_nearest.argtypes = lib.woop_nearest.argtypes
        lib.mt_nearest.restype = _I
        lib.mt_anyhit.argtypes = lib.woop_anyhit.argtypes
        lib.mt_anyhit.restype = _I
    return lib


def _device_of(a: torch.Tensor) -> str:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dense intersection kernel for {a.device}")
    return a.device.type


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _nearest(kernel: str, counter: str, floats: int, plain, table, ox, oy,
             oz, dx, dy, dz):
    n_tris = _check(table, (ox, oy, oz, dx, dy, dz), floats)
    if _device_of(ox) == "cpu":
        return plain(table, ox, oy, oz, dx, dy, dz)
    n = ox.shape[0]
    t = torch.empty_like(ox)
    idx = torch.empty(n, dtype=torch.int32, device=ox.device)
    bu = torch.empty_like(ox)
    bv = torch.empty_like(ox)
    if n == 0:
        return t, idx, bu, bv
    fn = getattr(_lib(), kernel)
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), n_tris, ox.data_ptr(), oy.data_ptr(),
                 oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
                 n, t.data_ptr(), idx.data_ptr(), bu.data_ptr(),
                 bv.data_ptr(), stream)
    _raise_on(err, kernel)
    LAUNCHES[counter] += 1
    return t, idx, bu, bv


def _anyhit(kernel: str, counter: str, floats: int, plain, table, ox, oy, oz,
            dx, dy, dz, dist):
    n_tris = _check(table, (ox, oy, oz, dx, dy, dz, dist), floats)
    if _device_of(ox) == "cpu":
        return plain(table, ox, oy, oz, dx, dy, dz, dist)
    n = ox.shape[0]
    hit = torch.empty(n, dtype=torch.int32, device=ox.device)
    if n == 0:
        return hit.bool()
    fn = getattr(_lib(), kernel)
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), n_tris, ox.data_ptr(), oy.data_ptr(),
                 oz.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
                 dist.data_ptr(), n, hit.data_ptr(), stream)
    _raise_on(err, kernel)
    LAUNCHES[counter] += 1
    return hit != 0


def tri_intersect(table, ox, oy, oz, dx, dy, dz):
    """Nearest triangle hit per ray over a Woop table -> (t, idx, bu, bv),
    [N] each; t = 3.4e38 and idx = -1 (int32) on a miss."""
    return _nearest("woop_nearest", "nearest", TRI_FLOATS,
                    tri_intersect_plain, table, ox, oy, oz, dx, dy, dz)


def tri_occluded(table, ox, oy, oz, dx, dy, dz, dist):
    """Any triangle hit with t < dist and |t - dist| >= 1e-4 over a Woop
    table -> bool [N]."""
    return _anyhit("woop_anyhit", "anyhit", TRI_FLOATS, tri_occluded_plain,
                   table, ox, oy, oz, dx, dy, dz, dist)


def _refuse_unaligned(table):
    if table.data_ptr() % 16:
        raise ValueError("the MT table must start on a 16-byte boundary "
                         "(the kernels read each triangle as 3 float4)")


def tri_intersect_mt(table, ox, oy, oz, dx, dy, dz):
    """``tri_intersect`` over an MT table (``pack_triangles``), which must
    start on a 16-byte boundary."""
    _refuse_unaligned(table)
    return _nearest("mt_nearest", "mt_nearest", MT_FLOATS,
                    tri_intersect_mt_plain, table, ox, oy, oz, dx, dy, dz)


def tri_occluded_mt(table, ox, oy, oz, dx, dy, dz, dist):
    """``tri_occluded`` over an MT table (``pack_triangles``), which must
    start on a 16-byte boundary."""
    _refuse_unaligned(table)
    return _anyhit("mt_anyhit", "mt_anyhit", MT_FLOATS, tri_occluded_mt_plain,
                   table, ox, oy, oz, dx, dy, dz, dist)


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


def _mt_tile(tri, ox, oy, oz, dx, dy, dz):
    """MT test of [N, 1] rays against a [C, 12] table slice -> (t, u, v, ok)
    [N, C], in the kernel's order of operations (``_kernel``)."""
    r = [tri[:, j][None, :] for j in range(MT_FLOATS)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nux, nuy, nuz = r
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    det = s1x * e1x + s1y * e1y + s1z * e1z
    dn = dx * nux + dy * nuy + dz * nuz
    inv = 1.0 / det     # det == 0 -> inf/NaN, rejected by det != 0
    t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
    u = (s1x * sx + s1y * sy + s1z * sz) * inv
    v = (s2x * dx + s2y * dy + s2z * dz) * inv
    ok = (dn.abs() >= PARALLEL_EPS) & (det != 0.0) & (t > 0.0) & (u > 0.0) \
        & (v > 0.0) & (1.0 - u - v > 0.0)
    return t, u, v, ok


def _nearest_plain(tile, floats, table, ox, oy, oz, dx, dy, dz):
    """Nearest hit over [N, 512] triangle tiles. The first minimum wins
    within a tile and a strict < across tiles, so an exact t tie keeps the
    lowest index, as in the kernels."""
    tri = table.reshape(-1, floats)
    n = ox.shape[0]
    t_best = torch.full((n,), F32_MAX, dtype=torch.float32, device=ox.device)
    idx = torch.full((n,), -1, dtype=torch.int32, device=ox.device)
    bu = torch.zeros_like(t_best)
    bv = torch.zeros_like(t_best)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    for lo in range(0, tri.shape[0], CHUNK):
        t, u, v, ok = tile(tri[lo:lo + CHUNK], *rays)
        t = torch.where(ok, t, F32_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)
        t_min = t.gather(1, j)[:, 0]
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        idx = torch.where(better, (lo + j[:, 0]).to(torch.int32), idx)
        bu = torch.where(better, u.gather(1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(1, j)[:, 0], bv)
    return t_best, idx, bu, bv


def _anyhit_plain(tile, floats, table, ox, oy, oz, dx, dy, dz, dist):
    """Any hit within ``dist`` over [N, 512] triangle tiles."""
    tri = table.reshape(-1, floats)
    blocked = torch.zeros(ox.shape[0], dtype=torch.bool, device=ox.device)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    d = dist[:, None]
    for lo in range(0, tri.shape[0], CHUNK):
        t, _, _, ok = tile(tri[lo:lo + CHUNK], *rays)
        ok = ok & (t < d) & ((t - d).abs() >= PARALLEL_EPS)
        blocked = blocked | ok.any(dim=1)
    return blocked


def tri_intersect_plain(table, ox, oy, oz, dx, dy, dz):
    """Plain PyTorch version of ``tri_intersect`` (Woop)."""
    return _nearest_plain(_woop_tile, TRI_FLOATS, table, ox, oy, oz, dx, dy,
                          dz)


def tri_occluded_plain(table, ox, oy, oz, dx, dy, dz, dist):
    """Plain PyTorch version of ``tri_occluded`` (Woop)."""
    return _anyhit_plain(_woop_tile, TRI_FLOATS, table, ox, oy, oz, dx, dy,
                         dz, dist)


def tri_intersect_mt_plain(table, ox, oy, oz, dx, dy, dz):
    """Plain PyTorch version of ``tri_intersect_mt``."""
    return _nearest_plain(_mt_tile, MT_FLOATS, table, ox, oy, oz, dx, dy, dz)


def tri_occluded_mt_plain(table, ox, oy, oz, dx, dy, dz, dist):
    """Plain PyTorch version of ``tri_occluded_mt``."""
    return _anyhit_plain(_mt_tile, MT_FLOATS, table, ox, oy, oz, dx, dy, dz,
                         dist)
