"""Emitter sampling over the scene light table.

The port of ``tuturenderer_tpu/ops/lights.py`` (sampleLight /
sampleLightDir / getLightPdf, IIntegrator.hpp:155-220), with its two compat
knobs:

- ``tutu_light_pick``: index = int(r*(size-1)+0.4999) (IIntegrator.hpp:184);
  the default is an unbiased uniform pick;
- ``tutu_tri_sample``: u=r0, v=r1*(1-u) (Triangle.hpp:119-135); the
  default is the uniform sqrt warp. Spheres are sampled uniformly in angles
  (Sphere.hpp:139-164).

``sample_light`` and ``light_pdf_of_hit`` are ``shade.light`` spans of
``utils/profiling.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..materials import PI
from ..scene.data import SPHERE, SceneData
from ..utils.profiling import spanned
from ..utils.vec import Vec3, local_to_world


class LightSample(NamedTuple):
    pos: Vec3
    ng: Vec3
    emission: Vec3
    pdf_area: torch.Tensor   # 1 / (n_lights * area)
    valid: torch.Tensor


def _gather_vec3(v: Vec3, idx) -> Vec3:
    """Per-lane rows of a per-light table; ``index_select`` for its cheap
    backward (``materials.gather_material``)."""
    return Vec3(*(torch.index_select(c, 0, idx) for c in v))


@spanned("shade.light")
def sample_light(scene: SceneData, r_pick, r0, r1,
                 tutu_light_pick: bool = False,
                 tutu_tri_sample: bool = False) -> LightSample:
    n = scene.n_lights
    if n == 0:
        zeros = torch.zeros_like(r_pick)
        z3 = Vec3(zeros, zeros, zeros)
        return LightSample(z3, z3, z3, zeros,
                           torch.zeros_like(r_pick, dtype=torch.bool))

    if tutu_light_pick and n > 1:
        pick = (r_pick * (n - 1) + 0.4999).to(torch.int32)
    else:
        pick = torch.clamp((r_pick * n).to(torch.int32), max=n - 1)
    pick = pick.long()
    kind = scene.light_kind[pick]
    idx = scene.light_idx[pick]
    area = scene.light_area[pick]

    # ---- triangle surface point, from the per-light [L] tables
    v0 = _gather_vec3(scene.light_v0, pick)
    v1 = _gather_vec3(scene.light_v1, pick)
    v2 = _gather_vec3(scene.light_v2, pick)
    n0 = _gather_vec3(scene.light_n0, pick)
    n1 = _gather_vec3(scene.light_n1, pick)
    n2 = _gather_vec3(scene.light_n2, pick)
    if tutu_tri_sample:
        u = r0
        v = r1 * (1.0 - u)
    else:
        su = torch.sqrt(torch.clamp(r0, min=0.0))
        u = 1.0 - su
        v = r1 * su
    w = 1.0 - u - v
    tpos = v0 * w + v1 * u + v2 * v
    tng = (n0 * w + n1 * u + n2 * v).normalized(1e-20)

    # ---- sphere surface point (uniform in angles, Sphere.hpp:147-152)
    if scene.n_spheres:
        is_sph = kind == SPHERE
        si = torch.where(is_sph, idx, 0).long()
        c = _gather_vec3(scene.scenter, si)
        r = scene.sradius[si]
        theta = r0 * 2.0 * PI
        phi = r1 * PI
        sp = Vec3(c.x + r * torch.cos(theta) * torch.sin(phi),
                  c.y + r * torch.sin(theta) * torch.sin(phi),
                  c.z + r * torch.cos(phi))
        sng = (sp - c).normalized(1e-20)
        pos = Vec3(torch.where(is_sph, sp.x, tpos.x),
                   torch.where(is_sph, sp.y, tpos.y),
                   torch.where(is_sph, sp.z, tpos.z))
        ng = Vec3(torch.where(is_sph, sng.x, tng.x),
                  torch.where(is_sph, sng.y, tng.y),
                  torch.where(is_sph, sng.z, tng.z))
    else:
        pos, ng = tpos, tng

    emission = _gather_vec3(scene.light_emission, pick)
    pdf = 1.0 / (n * area)
    return LightSample(pos=pos, ng=ng, emission=emission, pdf_area=pdf,
                       valid=torch.ones_like(r_pick, dtype=torch.bool))


@spanned("shade.light")
def light_pdf_of_hit(scene: SceneData, hit_kind, hit_idx, hit_mat,
                     hit_area=None):
    """getLightPdf (IIntegrator.hpp:155-168): 1/(n_lights * area) if the hit
    primitive emits, else 0. Pass ``hit_area`` (HitRecord.area) when
    available to skip the per-lane area gather."""
    n = scene.n_lights
    if n == 0:
        return torch.zeros_like(hit_kind, dtype=torch.float32)
    em = scene.materials.emission
    m = hit_mat.long()
    emissive = (em.x[m] != 0) | (em.y[m] != 0) | (em.z[m] != 0)
    if hit_area is not None:
        area = hit_area
    else:
        safe = torch.clamp(hit_idx, min=0)
        is_sph = hit_kind == SPHERE
        area_tri = scene.tarea[torch.where(is_sph, 0, safe).long()] \
            if scene.n_tris else torch.ones_like(hit_idx, dtype=torch.float32)
        if scene.n_spheres:
            area_sph = scene.sarea[torch.where(is_sph, safe, 0).long()]
            area = torch.where(is_sph, area_sph, area_tri)
        else:
            area = area_tri
    return torch.where(emissive, 1.0 / (n * torch.clamp(area, min=1e-20)),
                       0.0)


def sample_cosine_dir(n: Vec3, r0, r1):
    """Cosine-weighted emission direction (IIntegrator.hpp:195-220).
    Returns (dir, pdf, ok)."""
    cos_t = torch.sqrt(r0)
    sin_t = torch.sqrt(torch.clamp(1.0 - r0, min=0.0))
    phi = 2.0 * PI * r1
    d = local_to_world(n, Vec3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                               cos_t))
    ok = d.dot(n) >= 0.0
    pdf = torch.clamp(d.dot(n), min=0.0) / PI
    return d, pdf, ok
