"""Mesh-scale ray/triangle intersection over cluster tables: CUDA kernels
and their plain versions.

``cluster_intersect`` (nearest hit), ``cluster_occluded`` (any hit within a
distance) and ``cluster_transmittance`` (product of ``1 - alpha`` over the
crossings within a distance) replace the Pallas TPU kernels
``tuturenderer_tpu/ops/pallas/cluster.py::_kernel_nearest``,
``::_kernel_anyhit`` and ``::_kernel_transmit``. On a CUDA tensor each
launches its kernel or raises: all three walk the BVH of ``Clusters.bvh_*``
(``csrc/bvh_walk.cu``, one mode each); the transmittance reads each
crossed row's alpha from ``Clusters.woop`` (slot 13), so a table whose
``woop`` was replaced with ``dataclasses.replace`` is walked with its new
alphas. On a CPU tensor each runs the plain PyTorch version beside it,
which is also the kernels' oracle on the card. A wrapper refuses rays that
require grad.

The plain versions compute the same function densely: the same
per-triangle arithmetic over every real row of the table (``tri_idx >= 0``,
in row order), in tiles of 512 rows, then the ``tri_idx`` mapping. So the
kernels and the plain versions give bit-equal t, equal idx wherever t is
unique, bu/bv equal wherever idx is, equal any-hit masks, and
transmittances that differ only by the order of the product.

``test_count`` and ``node_count`` (optional int64 [1] tensors on the rays'
device) receive the number of ray/triangle tests and of BVH node visits
(two box tests each; the plain versions visit none): diagnostics, not
passed on the main path. The launches are counted in ``LAUNCHES`` (shared
with the dense kernels) under ``cluster_nearest``, ``cluster_anyhit`` and
``cluster_transmit``.
"""
from __future__ import annotations

import ctypes

import torch

from ..cluster import CLUSTER_SIZE, NODE_F, ROW_F, WOOP_F
from . import build
from .intersect import (CHUNK, F32_MAX, LAUNCHES, PARALLEL_EPS, _raise_on,
                        refuse_grad)

_P = ctypes.c_void_p
_I = ctypes.c_int

_TABLE_ARGS = 4      # _bvh_tables


def _bvh_lib():
    lib = build.load("bvh_walk")
    if lib.bvh_nearest.argtypes is None:
        lib.bvh_nearest.argtypes = [_P] * (_TABLE_ARGS + 6) + [_I] + \
            [_P] * 7
        lib.bvh_nearest.restype = _I
        for fn in (lib.bvh_anyhit, lib.bvh_transmit):
            fn.argtypes = [_P] * (_TABLE_ARGS + 7) + [_I] + [_P] * 4
            fn.restype = _I
    return lib


def _check(clusters, cols, *counts) -> str:
    """Validate the kernels' inputs; returns the device type."""
    dev = cols[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no cluster intersection kernel for {dev}")
    n = cols[0].shape[0] if cols[0].dim() == 1 else -1
    for a in cols:
        if a.dtype != torch.float32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError("expected contiguous 1-D float32 ray columns, "
                             f"got {a.dtype} of shape {tuple(a.shape)}")
        if a.shape[0] != n:
            raise ValueError("ray columns differ in length")
    refuse_grad(cols)
    c = clusters.aabb.shape[0]
    r = clusters.bvh_virt.shape[0]
    kb = max(clusters.bvh_nodes.shape[0], 1)     # the root at least
    want = ((clusters.aabb, torch.float32, (c, 8)),
            (clusters.woop, torch.float32, (c, 8, 128)),
            (clusters.tri_idx, torch.int32, (c, CLUSTER_SIZE)),
            (clusters.bvh_nodes, torch.float32, (kb, NODE_F)),
            (clusters.bvh_rows, torch.float32, (r, ROW_F)),
            (clusters.bvh_virt, torch.int32, (r,)))
    for a, dtype, shape in want:
        if a.dtype != dtype or tuple(a.shape) != shape or \
                not a.is_contiguous():
            raise ValueError(f"cluster table {a.dtype} {tuple(a.shape)} is "
                             f"not a contiguous {dtype} {shape}")
    if r != clusters.n_real:
        raise ValueError(f"{r} BVH rows for the {clusters.n_real} real rows "
                         "of tri_idx")
    for a in (*(t for t, _, _ in want), *cols):
        if a.device != dev:
            raise ValueError(f"tensors on {a.device} and {dev}")
    for count in counts:
        if count is not None and (count.dtype != torch.int64 or
                                  count.numel() != 1 or
                                  count.device != dev):
            raise ValueError("test_count and node_count must each be one "
                             "int64 on the rays' device")
    return dev.type


def _bvh_tables(clusters, last):
    """The kernels' table pointers: nodes, rows, virt and ``last``
    (``tri_idx`` for K5/K6, ``woop`` for K7)."""
    return (clusters.bvh_nodes.data_ptr(), clusters.bvh_rows.data_ptr(),
            clusters.bvh_virt.data_ptr(), last.data_ptr())


def _ptrs(cols):
    return [c.data_ptr() for c in cols]


def _counter(count):
    return None if count is None else count.data_ptr()


def _nearest_out(ox):
    n = ox.shape[0]
    return (torch.empty_like(ox), torch.empty(n, dtype=torch.int32,
                                              device=ox.device),
            torch.empty_like(ox), torch.empty_like(ox))


def cluster_intersect(clusters, ox, oy, oz, dx, dy, dz, test_count=None,
                      node_count=None):
    """Nearest triangle hit per ray -> (t, idx, bu, bv), [N] each; idx is
    the original triangle id (int32), t = 3.4e38 and idx = -1 on a miss."""
    cols = (ox, oy, oz, dx, dy, dz)
    if _check(clusters, cols, test_count, node_count) == "cpu":
        return cluster_intersect_plain(clusters, *cols, test_count)
    out = _nearest_out(ox)
    n = ox.shape[0]
    if n == 0:
        return out
    lib = _bvh_lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bvh_nearest(*_bvh_tables(clusters, clusters.tri_idx),
                              *_ptrs(cols), n, *_ptrs(out),
                              _counter(test_count), _counter(node_count),
                              stream)
    _raise_on(err, "bvh_nearest")
    LAUNCHES["cluster_nearest"] += 1
    return out


def cluster_occluded(clusters, ox, oy, oz, dx, dy, dz, dist,
                     test_count=None, node_count=None):
    """Any triangle hit with t < dist and |t - dist| >= 1e-4 -> bool [N]."""
    cols = (ox, oy, oz, dx, dy, dz, dist)
    if _check(clusters, cols, test_count, node_count) == "cpu":
        return cluster_occluded_plain(clusters, *cols, test_count)
    n = ox.shape[0]
    hit = torch.empty(n, dtype=torch.int32, device=ox.device)
    if n == 0:
        return hit.bool()
    lib = _bvh_lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bvh_anyhit(*_bvh_tables(clusters, clusters.tri_idx),
                             *_ptrs(cols), n, hit.data_ptr(),
                             _counter(test_count), _counter(node_count),
                             stream)
    _raise_on(err, "bvh_anyhit")
    LAUNCHES["cluster_anyhit"] += 1
    return hit != 0


def cluster_transmittance(clusters, ox, oy, oz, dx, dy, dz, dist,
                          test_count=None, node_count=None):
    """Product of (1 - alpha) over every triangle hit with t < dist ->
    float32 [N] (getShadowCoeffi, BVHStrategy.hpp:13-45)."""
    cols = (ox, oy, oz, dx, dy, dz, dist)
    if _check(clusters, cols, test_count, node_count) == "cpu":
        return cluster_transmittance_plain(clusters, *cols, test_count)
    n = ox.shape[0]
    trans = torch.empty_like(ox)
    if n == 0:
        return trans
    lib = _bvh_lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bvh_transmit(*_bvh_tables(clusters, clusters.woop),
                               *_ptrs(cols), n, trans.data_ptr(),
                               _counter(test_count), _counter(node_count),
                               stream)
    _raise_on(err, "bvh_transmit")
    LAUNCHES["cluster_transmit"] += 1
    return trans


# ------------------------------------------------------- plain versions

def real_rows(clusters):
    """(rows [R, 14], virtual ids [R]) of the table's real triangle rows in
    row order; virtual id = cluster * 64 + slot."""
    c = clusters.woop.shape[0]
    rows = clusters.woop.reshape(c, -1)[:, :CLUSTER_SIZE * WOOP_F] \
        .reshape(c * CLUSTER_SIZE, WOOP_F)
    virt = torch.nonzero(clusters.tri_idx.reshape(-1) >= 0)[:, 0]
    return rows[virt], virt


def _test_tile(rows, ox, oy, oz, dx, dy, dz):
    """The kernels' 12-value test of [N, 1] rays against a [C, 14] row
    slice -> (t, u, v, ok) [N, C], in their order of operations."""
    r = [rows[:, j][None, :] for j in range(12)]
    r1x, r1y, r1z, c1, r2x, r2y, r2z, c2, r3x, r3y, r3z, c3 = r
    w_o = ox * r3x + oy * r3y + oz * r3z - c3
    w_d = dx * r3x + dy * r3y + dz * r3z
    inv = 1.0 / w_d
    t = -w_o * inv
    u = (ox * r1x + oy * r1y + oz * r1z - c1) + \
        t * (dx * r1x + dy * r1y + dz * r1z)
    v = (ox * r2x + oy * r2y + oz * r2z - c2) + \
        t * (dx * r2x + dy * r2y + dz * r2z)
    ok = (w_d.abs() >= PARALLEL_EPS) & (t > 0.0) & (u > 0.0) & (v > 0.0) \
        & (1.0 - u - v > 0.0)
    return t, u, v, ok


def _count(test_count, n_rays, n_rows):
    if test_count is not None:
        test_count += n_rays * n_rows


def cluster_intersect_plain(clusters, ox, oy, oz, dx, dy, dz,
                            test_count=None):
    """Plain PyTorch nearest hit over [N, 512] row tiles. The first minimum
    wins within a tile and a strict < across tiles, so an exact t tie keeps
    the lowest virtual id."""
    rows, virt = real_rows(clusters)
    n = ox.shape[0]
    t_best = torch.full((n,), F32_MAX, dtype=torch.float32, device=ox.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    bu = torch.zeros_like(t_best)
    bv = torch.zeros_like(t_best)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    for lo in range(0, rows.shape[0], CHUNK):
        t, u, v, ok = _test_tile(rows[lo:lo + CHUNK], *rays)
        t = torch.where(ok, t, F32_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)
        t_min = t.gather(1, j)[:, 0]
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        best = torch.where(better, lo + j[:, 0], best)
        bu = torch.where(better, u.gather(1, j)[:, 0], bu)
        bv = torch.where(better, v.gather(1, j)[:, 0], bv)
    _count(test_count, n, rows.shape[0])
    tri = clusters.tri_idx.reshape(-1)[virt[best.clamp(min=0)]]
    idx = torch.where(best >= 0, tri, -1).to(torch.int32)
    return t_best, idx, bu, bv


def cluster_occluded_plain(clusters, ox, oy, oz, dx, dy, dz, dist,
                           test_count=None):
    """Plain PyTorch any hit within ``dist`` over [N, 512] row tiles. A ray
    with dist <= 0 (or NaN), as every dead lane of a shadow call has, is
    never blocked (a hit needs 0 < t < dist) and is not tested."""
    rows, _ = real_rows(clusters)
    blocked = torch.zeros(ox.shape[0], dtype=torch.bool, device=ox.device)
    live = torch.nonzero(dist > 0.0)[:, 0]
    rays = [c[live, None] for c in (ox, oy, oz, dx, dy, dz)]
    d = dist[live, None]
    hit = torch.zeros(live.shape[0], dtype=torch.bool, device=ox.device)
    for lo in range(0, rows.shape[0], CHUNK):
        t, _, _, ok = _test_tile(rows[lo:lo + CHUNK], *rays)
        ok = ok & (t < d) & ((t - d).abs() >= PARALLEL_EPS)
        hit = hit | ok.any(dim=1)
    blocked[live] = hit
    _count(test_count, live.shape[0], rows.shape[0])
    return blocked


def cluster_transmittance_plain(clusters, ox, oy, oz, dx, dy, dz, dist,
                                test_count=None):
    """Plain PyTorch product of (1 - alpha) over [N, 512] row tiles."""
    rows, _ = real_rows(clusters)
    trans = torch.ones(ox.shape[0], dtype=torch.float32, device=ox.device)
    rays = [c[:, None] for c in (ox, oy, oz, dx, dy, dz)]
    d = dist[:, None]
    for lo in range(0, rows.shape[0], CHUNK):
        tile = rows[lo:lo + CHUNK]
        t, _, _, ok = _test_tile(tile, *rays)
        ok = ok & (t < d)
        trans = trans * torch.where(ok, 1.0 - tile[:, 13][None, :],
                                    1.0).prod(dim=1)
    _count(test_count, ox.shape[0], rows.shape[0])
    return trans
