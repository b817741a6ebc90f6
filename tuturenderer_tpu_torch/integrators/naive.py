"""Naive path tracer: BDPT's s=0 strategy only (no NEE).

The port of ``tuturenderer_tpu/integrators/naive.py``. NaivePT
(NaivePT.hpp:23-170) is an eye random walk whose contribution is nonzero
only when the walk lands on an emitter, in the measurement-function
formulation ("way 2", NaivePT.hpp:92-101): the camera-vertex throughput is
cos/pdf_w with pdf_w the projected pixel pdf, and the pixel estimate is
emission * throughput * We(pixel).

Reference conventions kept: sampling/pdf/BxDF use the GEOMETRIC normal
(NaivePT.hpp:122-134), the walk is capped by the leaked MAXDEPTH=2 macro
(LightTracing.hpp:6 via include order, Renderer.hpp:27-28) exposed as
opts.lt_max_depth, and MIN_DIVISOR gates the walk (NaivePT.hpp:135).
Fixed (not reproduced): the argument bug passing scene eta where the
shading normal belongs (NaivePT.hpp:134); the real normal is passed.

Each step of the walk makes one nearest-hit call and no shadow call, so a
sample launches the nearest-hit kernel ``max(lt_max_depth, 2) - 1`` times.
"""
from __future__ import annotations

import torch

from ..camera import Camera, importance_we, primary_ray
from ..materials import bxdf_eval, bxdf_pdf, bxdf_sample, gather_material
from ..ops.intersect import intersect_core, shade_hit
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..utils import rng
from ..utils.vec import Vec3, reflect, where as vwhere
from .path import _zeros3, apply_textures


def trace_sample(scene, cam: Camera, px, py, lane, sample_idx, seed,
                 opts: RenderOptions) -> Vec3:
    n = px.shape[0]
    dev = px.device
    o, d, pixel_pos = primary_ray(cam, px, py)
    eta_scene = scene.eta
    types = scene.mtype_set

    # camera-vertex throughput, "way 2" (NaivePT.hpp:92-101)
    wi_n_cos = d.dot(cam.fwd).abs()
    d2 = (pixel_pos - cam.position).norm2()
    pdf_cam_w = d2 * cam.lens_area_inv * cam.film_area_inv / \
        torch.clamp(wi_n_cos, min=1e-20)
    tp0 = wi_n_cos / pdf_cam_w

    tp = Vec3(tp0, tp0, tp0)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    emission = _zeros3(n, dev)
    em_tp = _zeros3(n, dev)

    for t in range(1, max(opts.lt_max_depth, 2)):
        u = lambda purpose: rng.uniform(seed, lane, sample_idx, t, purpose)
        core = intersect_core(scene, o, d, mask=alive)
        hit = shade_hit(scene, o, d, core)
        params = gather_material(scene, hit.mat)
        params, _ = apply_textures(scene, hit, params)

        alive = alive & hit.hit
        emissive = params.emissive & alive
        # the walk terminates on emitters; record (emission, tp) for the
        # final-vertex contribution (NaivePT.hpp:118-119, 147-164)
        emission = vwhere(emissive, params.emission, emission)
        em_tp = vwhere(emissive, tp, em_tp)
        alive = alive & ~emissive

        ng = hit.ng
        wo = -d
        samp = bxdf_sample(params, wo, ng, u(rng.BSDF_U0), u(rng.BSDF_U1),
                           u(rng.BSDF_LOTTERY), eta_scene,
                           opts.ggx_sample_bug, types=types)
        wi = samp.wi
        pdf = bxdf_pdf(params, wi, wo, ng, eta_scene, params.eta, types=types)
        tir = samp.tir
        wi = vwhere(tir, reflect(wo, ng).normalized(1e-20), wi)
        pdf = torch.where(tir, 1.0, pdf)
        alive = alive & (samp.success | tir) & (pdf != 0.0) & \
            (pdf >= MIN_DIVISOR)
        cos = wi.dot(ng).abs()
        f = bxdf_eval(params, wi, wo, ng, ng, eta_scene, tir=tir,
                      types=types)
        tp = tp * f * (cos / torch.clamp(pdf, min=1e-20))

        ray_inside = ng.dot(wi) < 0.0
        o = hit.pos + vwhere(ray_inside, -ng, ng) * EPSILON
        d = wi

    we, _ = importance_we(cam, pixel_pos)
    return emission * em_tp * we


def render(scene, cam: Camera, opts: RenderOptions, seed=0,
           sample_base=0) -> torch.Tensor:
    """Full-frame render -> [H, W, 3] linear radiance on the scene's
    device. ``sample_base`` shifts the global sample indices
    (counter-based RNG) so chunked renders continue the exact stream. A
    sample whose radiance has a NaN channel counts as 0."""
    dev = scene.device
    p = cam.n_pixels
    lane = torch.arange(p, dtype=torch.int32, device=dev)
    px = lane % cam.width
    py = lane // cam.width
    acc = [torch.zeros((p,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    for s in range(opts.spp):
        L = trace_sample(scene, cam, px, py, lane, sample_base + s, seed,
                         opts)
        bad = torch.isnan(L.x) | torch.isnan(L.y) | torch.isnan(L.z)
        L = vwhere(bad, _zeros3(p, dev), L)
        acc = [acc[0] + L.x, acc[1] + L.y, acc[2] + L.z]
    inv = 1.0 / opts.spp
    img = torch.stack([a * inv for a in acc], dim=-1)
    return img.reshape(cam.height, cam.width, 3)
