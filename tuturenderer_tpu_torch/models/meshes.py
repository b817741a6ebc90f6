"""Procedural mesh generators (host-side numpy), the port's copy of
``tuturenderer_tpu/models/meshes.py`` (same numpy calls, so the same
vertices).

The reference ships only static OBJ assets (model/, loaded by
OBJ_Loader.h); its large-mesh showcase assets (bunny/buddha, README.md
images) were stripped from the repository. These generators produce
equivalent large-triangle-count geometry for exercising and benchmarking
the mesh-scale (cluster-kernel) path without binary assets.

All return ``verts [n, 3, 3]`` float32 (optionally with smooth normals
``[n, 3, 3]``), directly consumable by SceneBuilder.add_triangles.
"""
from __future__ import annotations

import numpy as np


def quad(p0, p1, p2, p3) -> np.ndarray:
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])], 0)


def plane(center, u_axis, v_axis, nu: int = 1, nv: int = 1) -> np.ndarray:
    """Subdivided parallelogram: center +- u_axis +- v_axis."""
    center = np.asarray(center, np.float32)
    ua = np.asarray(u_axis, np.float32)
    va = np.asarray(v_axis, np.float32)
    us = np.linspace(-1.0, 1.0, nu + 1)
    vs = np.linspace(-1.0, 1.0, nv + 1)
    pts = (center[None, None] + us[:, None, None] * ua[None, None]
           + vs[None, :, None] * va[None, None])   # [nu+1, nv+1, 3]
    q00 = pts[:-1, :-1]
    q10 = pts[1:, :-1]
    q01 = pts[:-1, 1:]
    q11 = pts[1:, 1:]
    t1 = np.stack([q00, q10, q11], 2).reshape(-1, 3, 3)
    t2 = np.stack([q00, q11, q01], 2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2], 0).astype(np.float32)


def uv_sphere(center=(0.0, 0.0, 0.0), radius: float = 1.0,
              nu: int = 64, nv: int = 64, smooth: bool = True):
    """Lat-long sphere mesh: 2*nu*nv triangles. Returns (verts, normals)
    with smooth per-vertex normals when ``smooth``."""
    center = np.asarray(center, np.float32)
    u = np.linspace(0.0, 2.0 * np.pi, nu + 1)
    v = np.linspace(1e-4, np.pi - 1e-4, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    n = np.stack([np.sin(vv) * np.cos(uu), np.sin(vv) * np.sin(uu),
                  np.cos(vv)], -1)
    p = center[None, None] + radius * n
    def corners(a):
        return a[:-1, :-1], a[1:, :-1], a[:-1, 1:], a[1:, 1:]
    p00, p10, p01, p11 = corners(p)
    n00, n10, n01, n11 = corners(n)
    # wound so the geometric normal points OUTWARD (matches the smooth
    # per-vertex normals; lat-long tangents du x dv point inward)
    verts = np.concatenate([
        np.stack([p00, p11, p10], 2).reshape(-1, 3, 3),
        np.stack([p00, p01, p11], 2).reshape(-1, 3, 3)], 0).astype(np.float32)
    if not smooth:
        return verts, None
    normals = np.concatenate([
        np.stack([n00, n11, n10], 2).reshape(-1, 3, 3),
        np.stack([n00, n01, n11], 2).reshape(-1, 3, 3)], 0).astype(np.float32)
    return verts, normals


def heightfield(nx: int = 128, nz: int = 128, size: float = 4.0,
                amplitude: float = 0.5, seed: int = 0):
    """Random smooth terrain patch (2*nx*nz triangles) centered at the
    origin in the XZ plane — a bunny-scale displacement workload."""
    r = np.random.RandomState(seed)
    # band-limited noise: sum of a few random cosines
    xs = np.linspace(-size / 2, size / 2, nx + 1)
    zs = np.linspace(-size / 2, size / 2, nz + 1)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(xx)
    for _ in range(6):
        kx, kz = r.randn(2) * 2.0
        ph = r.rand() * 2 * np.pi
        y += r.rand() * np.cos(kx * xx + kz * zz + ph)
    y *= amplitude / max(np.abs(y).max(), 1e-9)
    p = np.stack([xx, y, zz], -1)
    p00 = p[:-1, :-1]
    p10 = p[1:, :-1]
    p01 = p[:-1, 1:]
    p11 = p[1:, 1:]
    # wound so the geometric normal faces +y (up): terrain must be lit
    # from above under the BSDF sidedness rules
    verts = np.concatenate([
        np.stack([p00, p11, p10], 2).reshape(-1, 3, 3),
        np.stack([p00, p01, p11], 2).reshape(-1, 3, 3)], 0).astype(np.float32)
    return verts
