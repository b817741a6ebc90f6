"""Ray/scene intersection for dense scenes (fewer than 4096 triangles).

The port of ``tuturenderer_tpu/ops/intersect.py`` on its dense path:
triangles go through the Woop intersection of ``ops/cuda/intersect.py`` (a
CUDA kernel on the card, its plain PyTorch version on the CPU), spheres are
plain tensor code. Acceptance rules mirror the reference:

- triangles: |dir.n| >= 1e-4 and t, u, v, 1-u-v > 0 (Triangle.hpp:39-49);
- spheres: smallest strictly-positive root (Sphere.hpp:83-93);
- occlusion: a hit with t < dist and |t - dist| >= 1e-4 (BVH.hpp:184).

The alpha-shadow ``transmittance`` comes with ``alpha_shadows``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..scene.data import SPHERE, TRIANGLE, SceneData
from ..utils.vec import Vec3, where as vwhere
from .cuda.intersect import (F32_MAX, PARALLEL_EPS, pack_triangles_woop,
                             tri_intersect, tri_occluded)


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
    return [c.contiguous() for c in (*orig, *d)]


def intersect_core(scene: SceneData, orig: Vec3, d: Vec3,
                   mask=None) -> HitCore:
    """Nearest hit of each ray against the whole scene. ``mask`` (optional
    bool [N]): lanes with mask=False are traced as never-hit rays."""
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
    if scene.n_tris:
        t, idx, bu, bv = tri_intersect(pack_triangles_woop(scene),
                                       *_rays(orig, d))
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
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
        dist = torch.where(mask, dist, 0.0)
    if not scene.n_tris:
        core = intersect_core(scene, orig, d)
        return core.hit & (core.t < dist) & \
            ((core.t - dist).abs() >= PARALLEL_EPS)
    blocked = tri_occluded(pack_triangles_woop(scene), *_rays(orig, d),
                           dist.contiguous())
    if scene.n_spheres:
        blocked = blocked | _sphere_occluded(scene, orig, d, dist)
    return blocked


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

