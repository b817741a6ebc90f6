"""Light tracing (particle tracing): paths start at emitters and splat to
the film through the camera projection.

The port of ``tuturenderer_tpu/integrators/light.py`` (LightTracing,
LightTracing.hpp:25-206). Per sample: sample a light point and cosine
direction (IIntegrator.hpp:173-220), splat the directly visible light
through We (LightTracing.hpp:116-122), then random-walk with the ADJOINT
BSDF (LightTracing.hpp:143-178) and connect every vertex to the camera
with Geo * We and a shadow test (LightTracing.hpp:181-200).

Splats go into films of ``p + 1`` slots, ``p`` the pixel count: a lane
that splats nowhere (index -1) writes slot ``p``, which is sliced off at
the end, so no lane is filtered out with a host sync.

- The vertex connections accumulate with ``index_add_`` (the reference's
  ``FrameBuffer.addRGB`` under a lock).
- The direct light->eye splat uses setRGB (overwrite,
  LightTracing.hpp:121), whose result depends on write order when several
  samples project to the same pixel with different light points. As in the
  JAX package it is a deterministic channel max over a zero film
  (``scatter_reduce_(..., "amax", include_self=True)``) plus a mask of the
  pixels written; for a single visible sample it equals the overwrite.

``differentiable=True`` detaches the sampled light points, directions and
pdfs (the JAX package's ``stop_gradient`` sites): gradients flow through
emission, adjoint BSDF values and the We/Geo throughput chain.

Per sample the direct splat makes one shadow call, and each of the
``max(lt_max_depth, 2) - 1`` steps of the walk one nearest-hit call and
one shadow call.
"""
from __future__ import annotations

import torch

from ..camera import Camera, importance_we, primary_ray, world_to_pixel_index
from ..materials import bxdf_eval, bxdf_pdf, bxdf_sample, gather_material
from ..ops.intersect import intersect_core, occluded, shade_hit
from ..ops.lights import sample_cosine_dir, sample_light
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..utils import rng
from ..utils.vec import Vec3, reflect, where as vwhere
from .path import _detacher, apply_textures


def geo_term(p1: Vec3, n1: Vec3, p2: Vec3, n2: Vec3):
    """Geometry term (IIntegrator.hpp:223-230)."""
    v = p2 - p1
    d2 = v.norm2()
    vn = v.normalized(1e-20)
    return vn.dot(n1).abs() * (-vn).dot(n2).abs() / torch.clamp(d2, min=1e-20)


def trace_sample(scene, cam: Camera, lane, sample_idx, seed,
                 opts: RenderOptions):
    """One light path per lane. Returns (idx_list, rgb_list, direct_idx,
    direct_rgb): splat pixel indices [n] (int32, -1 for none) and Vec3
    [n] values, one per vertex: the direct splat first, then the
    ``max(lt_max_depth, 2) - 1`` vertex connections."""
    eta_scene = scene.eta
    types = scene.mtype_set
    u = lambda b, p: rng.uniform(seed, lane, sample_idx, b, p)
    sg = _detacher(opts)

    ls = sample_light(scene, u(0, rng.LIGHT_PICK), u(0, rng.LIGHT_U),
                      u(0, rng.LIGHT_V), opts.tutu_light_pick,
                      opts.tutu_tri_sample)
    ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng), pdf_area=sg(ls.pdf_area))
    pick_pdf = ls.pdf_area
    wi, dir_pdf, dir_ok = sample_cosine_dir(
        ls.ng, u(0, rng.LIGHT_DIR_U0), u(0, rng.LIGHT_DIR_U1))
    wi = sg(wi)
    dir_pdf = sg(dir_pdf)
    alive = ls.valid & dir_ok

    # direct light -> eye splat (LightTracing.hpp:116-122)
    orig0 = ls.pos + ls.ng * EPSILON
    to_cam = cam.position - orig0
    cam_dist = to_cam.norm()
    vis = ~occluded(scene, orig0,
                    to_cam * (1.0 / torch.clamp(cam_dist, min=1e-20)),
                    cam_dist, mask=ls.valid)
    we0, idx0 = importance_we(cam, ls.pos)
    direct_rgb = ls.emission * we0
    direct_idx = torch.where(ls.valid & vis & (idx0 >= 0), idx0, -1)

    # walk state: tp at the NEXT vertex = (1/pickpdf) * cos / dirPdf
    cos0 = wi.dot(ls.ng).abs()
    t0 = cos0 / torch.clamp(pick_pdf * dir_pdf, min=1e-20)
    o, d, tp = orig0, wi, Vec3(t0, t0, t0)

    idx_list = [direct_idx]
    rgb_list = [direct_rgb]

    for s in range(1, max(opts.lt_max_depth, 2)):
        core = intersect_core(scene, o, d, mask=alive)
        hit = shade_hit(scene, o, d, core)
        params = gather_material(scene, hit.mat)
        params, ns = apply_textures(scene, hit, params)
        hit = hit._replace(ns=ns)
        alive = alive & hit.hit
        wo = -d

        # per-vertex camera connection (LightTracing.hpp:181-200)
        g = geo_term(cam.position, cam.fwd, hit.pos, hit.ng)
        wi_c = (cam.position - hit.pos).normalized(1e-20)
        f_c = bxdf_eval(params, wi_c, wo, hit.ng, hit.ns,
                        torch.ones_like(eta_scene), adjoint=True,
                        types=types)
        we, idx = importance_we(cam, hit.pos)
        contrib = ls.emission * f_c * tp * (g * we)
        inside_c = hit.ns.dot(wo) < 0.0
        oc = hit.pos + vwhere(inside_c, -hit.ns, hit.ns) * EPSILON
        toc = cam.position - oc
        dc = toc.norm()
        viso = ~occluded(scene, oc,
                         toc * (1.0 / torch.clamp(dc, min=1e-20)), dc,
                         mask=alive & (idx >= 0))
        ok = alive & viso & (idx >= 0)
        idx_list.append(torch.where(ok, idx, -1))
        rgb_list.append(contrib)

        # continuation with the adjoint BSDF (LightTracing.hpp:152-178)
        samp = bxdf_sample(params, wo, hit.ns, u(s, rng.BSDF_U0),
                           u(s, rng.BSDF_U1), u(s, rng.BSDF_LOTTERY),
                           eta_scene, opts.ggx_sample_bug, types=types)
        nwi = sg(samp.wi)
        pdf = sg(bxdf_pdf(params, nwi, wo, hit.ns, eta_scene, params.eta,
                          types=types))
        tir = samp.tir
        nwi = vwhere(tir, reflect(wo, hit.ns).normalized(1e-20), nwi)
        pdf = torch.where(tir, 1.0, pdf)
        alive = alive & samp.success & (pdf != 0.0) & (pdf >= MIN_DIVISOR)
        cos = nwi.dot(hit.ng).abs()
        f = bxdf_eval(params, nwi, wo, hit.ng, hit.ns, eta_scene,
                      adjoint=True, tir=tir, types=types)
        tp = tp * f * (cos / torch.clamp(pdf, min=1e-20))

        inside = hit.ns.dot(nwi) < 0.0
        o = hit.pos + vwhere(inside, -hit.ns, hit.ns) * EPSILON
        d = nwi

    return idx_list, rgb_list, direct_idx, direct_rgb


def _lanes(cam: Camera, device):
    """(lane, px, py) of one lane per pixel, row-major, int32."""
    lane = torch.arange(cam.n_pixels, dtype=torch.int32, device=device)
    return lane, lane % cam.width, lane // cam.width


def _slot(idx, p: int):
    """Film slot of a splat index: the pixel, or the spare slot ``p``."""
    return torch.where(idx >= 0, idx, p).long()


def splat_film(film: torch.Tensor, splat_idx, splat_rgb) -> torch.Tensor:
    """``film`` [p + 1, 3] plus every splat (pixel indices [n], -1 for
    none, and Vec3 values) at its pixel; an off-film splat goes to the
    spare slot ``p`` with its value zeroed, as the JAX package drops it."""
    p = film.shape[0] - 1
    for idx, rgb in zip(splat_idx, splat_rgb):
        on = (idx >= 0)[:, None]
        film = film.index_add(0, _slot(idx, p),
                              torch.where(on, torch.stack(tuple(rgb), -1),
                                          0.0))
    return film


def raster_check(scene, cam: Camera, opts: RenderOptions, seed=0):
    """CHECK_LT-equivalent debug pass (LightTracing.hpp:5, 28-93): trace a
    primary ray per pixel, project the hit point back through the camera's
    world->raster chain, and write the surface albedo at the PROJECTED
    pixel. If ``worldPos2PixelIndex`` is consistent with ray generation,
    the output is a flat-shaded image of the scene in place; any
    projection error shows up as smearing/displacement. Returns the debug
    image [H, W, 3]. Where two lanes project to one pixel, which one's
    color stays is unspecified, as in the JAX package."""
    p = cam.n_pixels
    lane, px, py = _lanes(cam, scene.device)
    o, d, _ = primary_ray(cam, px, py)
    core = intersect_core(scene, o, d)
    hit = shade_hit(scene, o, d, core)
    params = gather_material(scene, hit.mat)
    idx = world_to_pixel_index(cam, hit.pos)
    ok = hit.hit & (idx >= 0)
    color = vwhere(params.emissive, params.emission, params.diffuse)
    bkg = scene.bkgcolor
    film = torch.stack([torch.zeros((p + 1,), device=scene.device) + c
                        for c in bkg], dim=-1)
    rgb = torch.stack([torch.where(ok, c, 0.0) for c in color], dim=-1)
    film[_slot(torch.where(ok, idx, -1), p)] = rgb
    return film[:p].reshape(cam.height, cam.width, 3)


def raster_roundtrip_error(scene, cam: Camera):
    """Fraction of hit pixels whose hit point projects back to a DIFFERENT
    pixel index: the quantitative form of the CHECK_LT eyeball test.
    Should be ~0 for a consistent camera (boundary pixels may round across
    an edge). A 0-d float32 tensor."""
    lane, px, py = _lanes(cam, scene.device)
    o, d, _ = primary_ray(cam, px, py)
    core = intersect_core(scene, o, d)
    hit = shade_hit(scene, o, d, core)
    idx = world_to_pixel_index(cam, hit.pos)
    mism = hit.hit & (idx != lane)
    n_hit = torch.clamp(hit.hit.sum(), min=1)
    return (mism.sum() / n_hit).to(torch.float32)


def render(scene, cam: Camera, opts: RenderOptions, seed=0, sample_base=0,
           return_parts: bool = False):
    """Full-frame render -> [H, W, 3] linear radiance on the scene's
    device. ``sample_base`` shifts the global sample indices
    (counter-based RNG) so chunked renders continue the exact stream.
    ``return_parts=True`` returns the raw accumulators (splat_sum
    [H,W,3], direct_max_unscaled [H,W,3], dmask [H,W] bool) instead of the
    composed image, so a chunked render can max-combine direct splats and
    sum connection splats across chunks exactly."""
    dev = scene.device
    p = cam.n_pixels
    lane, _, _ = _lanes(cam, dev)
    splat = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
    direct = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
    dmask = torch.zeros((p + 1,), dtype=torch.bool, device=dev)
    stack = lambda v: torch.stack(tuple(v), dim=-1)
    for s in range(opts.spp):
        idx_list, rgb_list, didx, drgb = trace_sample(
            scene, cam, lane, sample_base + s, seed, opts)
        # the direct pane: channel max of the RAW per-sample value; the
        # reference's SPP_inv scale (LightTracing.hpp:121) is applied at
        # composition
        dslot = _slot(didx, p)
        direct.scatter_reduce_(0, dslot[:, None].expand(-1, 3), stack(drgb),
                               "amax", include_self=True)
        dmask.index_fill_(0, dslot, True)
        # vertex-connection splats: addRGB accumulation (raw sums)
        splat = splat_film(splat, idx_list[1:], rgb_list[1:])
    hw = (cam.height, cam.width)
    splat = splat[:p].reshape(*hw, 3)
    direct = direct[:p].reshape(*hw, 3)
    dmask = dmask[:p].reshape(*hw)
    if return_parts:
        return splat, direct, dmask
    return compose_light_film(scene, cam, splat, direct, dmask, opts.spp)


def compose_light_film(scene, cam: Camera, splat_sum, direct_max, dmask,
                       total_spp):
    """Compose the light-tracing film from raw accumulators: background
    where nothing wrote, SPP_inv-scaled direct overwrite + averaged
    connection splats (LightTracing.hpp:116-122, 181-200)."""
    spp_inv = 1.0 / total_spp
    bkg = scene.bkgcolor
    zero = torch.zeros(dmask.shape, dtype=torch.float32,
                       device=dmask.device)
    bkg_img = torch.stack([zero + bkg.x, zero + bkg.y, zero + bkg.z], dim=-1)
    img = torch.where(dmask[..., None], direct_max * spp_inv, bkg_img) + \
        splat_sum * spp_inv
    return torch.where(torch.isnan(img), 0.0, img)
