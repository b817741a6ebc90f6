"""Ray/scene intersection.

The port of ``tuturenderer_tpu/ops/intersect.py``. Triangles of a dense
scene (fewer than 4096 triangles) go through the dense kernels of
``ops/cuda/intersect.py``, in the form ``DENSE_KERNEL`` names; a scene with
cluster tables goes through the cluster kernels of ``ops/cuda/cluster.py``
(nearest hit, any hit, transmittance). Each is a CUDA kernel on the card
and its plain PyTorch version on the CPU. Spheres are plain tensor code.
The kernels are geometry-only and have no backward: the rays are detached
where they enter one, as the JAX package stops their gradient at its
Pallas kernels. Acceptance rules mirror the reference:

- triangles: |dir.n| >= 1e-4 and t, u, v, 1-u-v > 0 (Triangle.hpp:39-49);
- spheres: smallest strictly-positive root (Sphere.hpp:83-93);
- occlusion: a hit with t < dist and |t - dist| >= 1e-4 (BVH.hpp:184);
- transmittance: the product of (1 - alpha) over every crossing with
  t < dist (BVHStrategy.hpp:13-45).

The JAX package traces a cluster scene's wavefront in octant-Morton order
on the TPU; the port traces it in the caller's order.

Each query is a span of ``utils/profiling.py`` (``isect.nearest``,
``isect.anyhit``, ``isect.transmit``, and ``shade.hit``), the one place
every integrator's queries pass; while spans record, a query's span
carries the lanes it was launched with and the lanes its mask lets
through: two launches more a masked query on the card (the mask's cast to
int64 and its sum), and no sync. On the card a cluster query's span also
carries the BVH walk's ``visits`` (node visits) and ``tests`` (ray/triangle
tests), summed over every lane the kernel was launched with, a dead lane
included (its one visit of the root): 0-d int64 device tensors that the
kernel adds into, one launch more (their zeroing). While nothing records
the kernels get no counters, so a CUDA graph captures none. The dense
kernels and the plain versions visit no node, and their spans carry
neither.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.data import SPHERE, TRIANGLE, SceneData
from ..utils.profiling import OFF, count_lanes, span, spanned
from ..utils.vec import Vec3, where as vwhere
from .cuda.cluster import (cluster_intersect, cluster_occluded,
                           cluster_transmittance)
from .cuda.intersect import (CHUNK, F32_MAX, PARALLEL_EPS, pack_triangles,
                             pack_triangles_woop, tri_intersect,
                             tri_intersect_mt, tri_occluded, tri_occluded_mt)

# The form of the dense triangle test, the counterpart of the JAX package's
# ops/pallas/intersect.py PALLAS_IMPL and read at call time: "woop" (the
# prefactored rows, K1/K2) or "mt" (Moller-Trumbore, K3/K4, the arithmetic
# the JAX package computes off the TPU). The two accept the same triangles
# up to rounding on edge-grazing rays.
DENSE_KERNEL = "woop"


class HitCore(NamedTuple):
    """Minimal nearest-hit record produced by the traversal reduction."""
    t: torch.Tensor      # [N] f32, F32_MAX on miss
    kind: torch.Tensor   # [N] int32 TRIANGLE/SPHERE
    idx: torch.Tensor    # [N] int32 primitive index, -1 on miss
    bu: torch.Tensor     # [N] f32 barycentric u (triangles)
    bv: torch.Tensor     # [N] f32 barycentric v

    @property
    def hit(self):
        return self.idx >= 0


class HitRecord(NamedTuple):
    """Full shading record (Intersection.hpp:13-31)."""
    t: torch.Tensor
    hit: torch.Tensor
    pos: Vec3
    ng: Vec3            # geometric normal
    ns: Vec3            # shading normal
    u: torch.Tensor     # texture coords
    v: torch.Tensor
    mat: torch.Tensor   # [N] int32 material id (0 where miss; gate with hit)
    kind: torch.Tensor
    idx: torch.Tensor
    area: torch.Tensor  # [N] f32 primitive surface area (light-pdf input)


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _empty_core(n: int, device) -> HitCore:
    return HitCore(
        t=torch.full((n,), F32_MAX, dtype=torch.float32, device=device),
        kind=torch.zeros((n,), dtype=torch.int32, device=device),
        idx=torch.full((n,), -1, dtype=torch.int32, device=device),
        bu=torch.zeros((n,), dtype=torch.float32, device=device),
        bv=torch.zeros((n,), dtype=torch.float32, device=device))


def _sphere_best(scene: SceneData, orig: Vec3, d: Vec3,
                 best: HitCore) -> HitCore:
    if scene.n_spheres == 0:
        return best
    cx = scene.scenter.x[None, :]
    cy = scene.scenter.y[None, :]
    cz = scene.scenter.z[None, :]
    r = scene.sradius[None, :]
    lx = orig.x[:, None] - cx
    ly = orig.y[:, None] - cy
    lz = orig.z[:, None] - cz
    b = d.x[:, None] * lx + d.y[:, None] * ly + d.z[:, None] * lz   # = B/2
    c = lx * lx + ly * ly + lz * lz - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = torch.where(t1 > 0.0, t1, t2)
    ok = (disc >= 0.0) & (t > 0.0)
    t = torch.where(ok, t, F32_MAX)

    j = torch.argmin(t, dim=1, keepdim=True)
    t_min = t.gather(1, j)[:, 0]
    better = t_min < best.t
    return HitCore(
        t=torch.where(better, t_min, best.t),
        kind=torch.where(better, SPHERE, best.kind),
        idx=torch.where(better, j[:, 0].to(torch.int32), best.idx),
        bu=best.bu, bv=best.bv,
    )


def _mask_rays(orig: Vec3, d: Vec3, mask):
    """Replace dead lanes with a degenerate ray far outside the scene
    pointing away from it, which fails every triangle and sphere test."""
    far = -1e7
    orig = Vec3(torch.where(mask, orig.x, far), torch.where(mask, orig.y, far),
                torch.where(mask, orig.z, far))
    d = Vec3(torch.where(mask, d.x, 0.0), torch.where(mask, d.y, -1.0),
             torch.where(mask, d.z, 0.0))
    return orig, d


def _rays(orig: Vec3, d: Vec3):
    """The ray columns as a kernel takes them, detached."""
    return [c.detach().contiguous() for c in (*orig, *d)]


def _dense(nearest: bool, scene: SceneData):
    """(kernel wrapper, table) of the dense form ``DENSE_KERNEL`` names."""
    if DENSE_KERNEL == "woop":
        return (tri_intersect if nearest else tri_occluded), \
            pack_triangles_woop(scene)
    if DENSE_KERNEL == "mt":
        return (tri_intersect_mt if nearest else tri_occluded_mt), \
            pack_triangles(scene)
    raise ValueError(f"DENSE_KERNEL {DENSE_KERNEL!r}: 'woop' or 'mt'")


def _walk_counters(sp, device) -> dict:
    """The cluster kernels' counters while ``sp`` records on the card:
    {"test_count", "node_count"}, int64 [1] views of one zeroed tensor,
    whose elements the span carries as ``tests`` and ``visits``; else {}
    (the kernels count nothing)."""
    if not sp.on or device.type != "cuda":
        return {}
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    sp.count("visits", counts[0])
    sp.count("tests", counts[1])
    return {"node_count": counts[0:1], "test_count": counts[1:2]}


def intersect_core(scene: SceneData, orig: Vec3, d: Vec3,
                   mask=None) -> HitCore:
    """Nearest hit of each ray against the whole scene. ``mask`` (optional
    bool [N]): lanes with mask=False are traced as never-hit rays."""
    with span("isect.nearest") as sp:
        count_lanes(sp, orig.x.shape[0], mask)
        return _nearest(scene, orig, d, mask, sp)


def _nearest(scene: SceneData, orig: Vec3, d: Vec3, mask=None,
             sp=OFF) -> HitCore:
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
    if scene.clusters is not None:
        t, idx, bu, bv = cluster_intersect(
            scene.clusters, *_rays(orig, d),
            **_walk_counters(sp, orig.x.device))
        best = HitCore(t=t, kind=torch.zeros_like(idx), idx=idx, bu=bu, bv=bv)
    elif scene.n_tris:
        kernel, table = _dense(True, scene)
        t, idx, bu, bv = kernel(table, *_rays(orig, d))
        best = HitCore(t=t, kind=torch.zeros_like(idx), idx=idx, bu=bu, bv=bv)
    else:
        best = _empty_core(orig.x.shape[0], orig.x.device)
    best = _sphere_best(scene, orig, d, best)
    miss = best.t >= F32_MAX
    return best._replace(idx=torch.where(miss, -1, best.idx))


def _sphere_occluded(scene: SceneData, orig: Vec3, d: Vec3, dist):
    """Any sphere hit with t < dist (+ FLOAT_EQUAL endpoint guard)."""
    best = _sphere_best(scene, orig, d,
                        _empty_core(orig.x.shape[0], orig.x.device))
    return best.hit & (best.t < dist) & \
        ((best.t - dist).abs() >= PARALLEL_EPS)


def occluded(scene: SceneData, orig: Vec3, d: Vec3, dist,
             mask=None) -> torch.Tensor:
    """Any hit within ``dist`` (shadow ray), with the FLOAT_EQUAL guard at
    the endpoint (hasIntersection, BVH.hpp:170-194). Dead lanes (mask
    False) become degenerate rays with dist 0 and report unblocked."""
    with span("isect.anyhit") as sp:
        count_lanes(sp, orig.x.shape[0], mask)
        return _occluded(scene, orig, d, dist, mask, sp)


def _occluded(scene: SceneData, orig: Vec3, d: Vec3, dist, mask=None,
              sp=OFF):
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
        dist = torch.where(mask, dist, 0.0)
    if not scene.n_tris:
        core = _nearest(scene, orig, d)
        return core.hit & (core.t < dist) & \
            ((core.t - dist).abs() >= PARALLEL_EPS)
    if scene.clusters is not None:
        blocked = cluster_occluded(scene.clusters, *_rays(orig, d),
                                   dist.detach().contiguous(),
                                   **_walk_counters(sp, orig.x.device))
    else:
        kernel, table = _dense(False, scene)
        blocked = kernel(table, *_rays(orig, d), dist.detach().contiguous())
    if scene.n_spheres:
        blocked = blocked | _sphere_occluded(scene, orig, d, dist)
    return blocked


def transmittance(scene: SceneData, orig: Vec3, d: Vec3, dist,
                  mask=None) -> torch.Tensor:
    """Alpha-weighted shadow coefficient: the product of ``(1 - alpha)``
    over every primitive the shadow ray crosses within ``dist``
    (getShadowCoeffi/ShadowHelper, BVHStrategy.hpp:13-45,
    BaseInterStrategy.hpp:25-43). Fully opaque occluders (alpha 1) give 0.
    A cluster scene's triangles go through the transmittance kernel; a
    dense scene's are evaluated here in chunks of 512, with the
    Moller-Trumbore test of the JAX package's dense loop. ``dist`` is [N].
    Dead lanes (mask False) get dist 0 and a degenerate ray:
    transmittance 1."""
    with span("isect.transmit") as sp:
        count_lanes(sp, orig.x.shape[0], mask)
        return _transmittance(scene, orig, d, dist, mask, sp)


def _transmittance(scene: SceneData, orig: Vec3, d: Vec3, dist, mask=None,
                   sp=OFF):
    n = orig.x.shape[0]
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
        dist = torch.where(mask, dist, 0.0)

    if scene.clusters is not None:
        trans = cluster_transmittance(scene.clusters, *_rays(orig, d),
                                      dist.detach().contiguous(),
                                      **_walk_counters(sp, orig.x.device))
        if scene.n_spheres:
            trans = trans * _sphere_transmittance(scene, orig, d, dist)
        return trans

    trans = torch.ones((n,), dtype=torch.float32, device=orig.x.device)
    for lo in range(0, scene.n_tris, CHUNK):
        sl = slice(lo, lo + CHUNK)
        v0 = Vec3(scene.tv0.x[sl], scene.tv0.y[sl], scene.tv0.z[sl])
        v1 = Vec3(scene.tv1.x[sl], scene.tv1.y[sl], scene.tv1.z[sl])
        v2 = Vec3(scene.tv2.x[sl], scene.tv2.y[sl], scene.tv2.z[sl])
        e1 = v1 - v0
        e2 = v2 - v0
        nrm = e1.cross(e2)
        n_unit = nrm * (1.0 / torch.clamp(nrm.norm(), min=1e-30))
        dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
        sx = orig.x[:, None] - v0.x[None, :]
        sy = orig.y[:, None] - v0.y[None, :]
        sz = orig.z[:, None] - v0.z[None, :]
        s1x = dy * e2.z[None, :] - dz * e2.y[None, :]
        s1y = dz * e2.x[None, :] - dx * e2.z[None, :]
        s1z = dx * e2.y[None, :] - dy * e2.x[None, :]
        s2x = sy * e1.z[None, :] - sz * e1.y[None, :]
        s2y = sz * e1.x[None, :] - sx * e1.z[None, :]
        s2z = sx * e1.y[None, :] - sy * e1.x[None, :]
        det = s1x * e1.x[None, :] + s1y * e1.y[None, :] + s1z * e1.z[None, :]
        dn = dx * n_unit.x[None, :] + dy * n_unit.y[None, :] \
            + dz * n_unit.z[None, :]
        inv = 1.0 / torch.where(det == 0.0, 1.0, det)
        t = (s2x * e2.x[None, :] + s2y * e2.y[None, :]
             + s2z * e2.z[None, :]) * inv
        u = (s1x * sx + s1y * sy + s1z * sz) * inv
        v = (s2x * dx + s2y * dy + s2z * dz) * inv
        ok = (dn.abs() >= PARALLEL_EPS) & (det != 0.0) & (t > 0.0) \
            & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0) \
            & (t < dist[:, None])
        a = scene.materials.alpha[scene.tmat[sl].long()][None, :]   # [1,C]
        trans = trans * torch.where(ok, 1.0 - a, 1.0).prod(dim=1)

    if scene.n_spheres:
        trans = trans * _sphere_transmittance(scene, orig, d, dist)
    return trans


def _sphere_transmittance(scene: SceneData, orig: Vec3, d: Vec3, dist):
    lx = orig.x[:, None] - scene.scenter.x[None, :]
    ly = orig.y[:, None] - scene.scenter.y[None, :]
    lz = orig.z[:, None] - scene.scenter.z[None, :]
    b = d.x[:, None] * lx + d.y[:, None] * ly + d.z[:, None] * lz
    c = lx * lx + ly * ly + lz * lz \
        - scene.sradius[None, :] * scene.sradius[None, :]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = torch.where(t1 > 0.0, t1, t2)
    ok = (disc >= 0.0) & (t > 0.0) & (t < dist[:, None])
    a = scene.materials.alpha[scene.smat.long()][None, :]
    return torch.where(ok, 1.0 - a, 1.0).prod(dim=1)


@spanned("shade.hit")
def shade_hit(scene: SceneData, orig: Vec3, d: Vec3,
              core: HitCore) -> HitRecord:
    """Expand a HitCore into a full shading record by gathering the winning
    primitive's attributes (Triangle.hpp:50-69, Sphere.hpp:95-123).
    Triangles read one packed ``tri_shade`` [T, 20] row each."""
    safe_idx = torch.clamp(core.idx, min=0)
    is_tri = core.kind == TRIANGLE

    # clamp the miss distance so pos and r^2 stay finite
    t_safe = torch.where(core.hit, core.t, 1.0)
    pos = orig + d * t_safe
    zeros = torch.zeros_like(pos.x)
    zerov = Vec3(zeros, zeros, zeros)

    if scene.n_tris:
        ti = torch.where(is_tri, safe_idx, 0).long()
        w = 1.0 - core.bu - core.bv
        rows = scene.tri_shade[ti]               # [N, 20]
        col = lambda j: rows[:, j]
        n0 = Vec3(col(0), col(1), col(2))
        n1 = Vec3(col(3), col(4), col(5))
        n2 = Vec3(col(6), col(7), col(8))
        ng_tri = Vec3(col(9), col(10), col(11))      # prenormalized cross
        ns_tri = (n0 * w + n1 * core.bu + n2 * core.bv).normalized(1e-30)
        u_tri = col(12) * w + col(14) * core.bu + col(16) * core.bv
        v_tri = col(13) * w + col(15) * core.bu + col(17) * core.bv
        mat_tri = col(18).to(torch.int32)
        area_tri = col(19)
    else:
        ng_tri = ns_tri = zerov
        u_tri = v_tri = zeros
        mat_tri = torch.zeros_like(core.idx)
        area_tri = zeros

    if scene.n_spheres:
        si = torch.where(is_tri, 0, safe_idx).long()
        c = _gather_vec3(scene.scenter, si)
        ng_sph = (pos - c).normalized(1e-30)
        # spherical uv (Sphere.hpp:59-77): v = acos(z)/pi, u = atan2/2pi
        phi = torch.acos(torch.clamp(ng_sph.z, -1.0, 1.0))
        v_sph = phi / math.pi
        theta = torch.atan2(ng_sph.y, ng_sph.x)
        theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
        u_sph = theta / (2.0 * math.pi)
        mat_sph = scene.smat[si]
        area_sph = scene.sarea[si]
        ng = vwhere(is_tri, ng_tri, ng_sph)
        ns = vwhere(is_tri, ns_tri, ng_sph)
        u = torch.where(is_tri, u_tri, u_sph)
        v = torch.where(is_tri, v_tri, v_sph)
        mat = torch.where(core.hit, torch.where(is_tri, mat_tri, mat_sph), 0)
        area = torch.where(is_tri, area_tri, area_sph)
    else:
        ng, ns = ng_tri, ns_tri
        u, v = u_tri, v_tri
        mat = torch.where(core.hit, mat_tri, 0)
        area = area_tri

    return HitRecord(t=core.t, hit=core.hit, pos=pos, ng=ng, ns=ns, u=u, v=v,
                     mat=mat, kind=core.kind, idx=core.idx, area=area)


def intersect_scene(scene: SceneData, orig: Vec3, d: Vec3) -> HitRecord:
    return shade_hit(scene, orig, d, intersect_core(scene, orig, d))
