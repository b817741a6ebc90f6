"""Wavefront unidirectional path tracer with NEE + power-heuristic MIS.

The port of ``tuturenderer_tpu/integrators/path.py`` on its main path: the
MIS estimator without compaction. One wavefront of lanes is traced through
a Python loop of ``max_depth + 1`` bounces and an epilogue; per-material
virtual calls are masked blends and finished lanes carry a dead mask. The
estimator is the reference's recursive ``traceRay``
(PathTracing.hpp:136-349):

- camera rays through pixel centers (PathTracing.hpp:377-391, 444);
- at each vertex: NEE light sample with solid-angle-converted MIS weight
  (PathTracing.hpp:180-219), BSDF sample with the mirrored MIS weight on
  emissive hits (PathTracing.hpp:222-261), Russian roulette gated by
  MIN_DEPTH on the running throughput (PathTracing.hpp:263-277);
- PERFECT_REFRACTIVE / MICROFACET_T vertices take the dielectric path with
  TIR handling (calcForRefractive, PathTracing.hpp:80-134), which skips NEE
  and resets the RR throughput;
- MIN_DIVISOR kill thresholds reproduced (PathTracing.hpp:215, 257, 272).

Each bounce makes one nearest-hit and one shadow any-hit call, so a sample
launches the dense kernels (max_depth + 2) and (max_depth + 1) times.

Not served yet, each raising ``NotImplementedError`` with its ROADMAP item:
``mis=False`` (the NEE-only branch), ``compaction``, ``alpha_shadows`` and
``differentiable=True``. Scenes with BVH/cluster tables, the only ones the
JAX package sorts its wavefront for, cannot be built in this package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..camera import Camera, primary_ray
from ..materials import (MatParams, bxdf_eval, bxdf_pdf, bxdf_sample,
                         d_ndf, gather_material, mis_power_weight)
from ..ops.intersect import intersect_core, occluded, shade_hit
from ..ops.lights import light_pdf_of_hit, sample_light
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..scene.data import (MICROFACET_T, PERFECT_REFLECTIVE, UNLIT, SceneData)
from ..utils import rng
from ..utils.vec import Vec3, reflect, where as vwhere

# lane provenance at loop top (what produced the current ray)
FROM_CAMERA = 0
FROM_BSDF = 1       # BSDF sample of a non-refractive vertex (MIS pending)
FROM_REFRACT = 2    # calcForRefractive continuation

# options this package does not serve yet: (asked for?, what, the ROADMAP
# queue 1 item that brings it)
_UNPORTED = (
    (lambda o: not o.mis, "the NEE-only estimator (mis=False)", 6),
    (lambda o: bool(o.compaction), "wavefront compaction", 9),
    (lambda o: o.alpha_shadows, "alpha shadows", 4),
    (lambda o: o.differentiable, "the differentiable renderer", 11),
)


def _check_options(opts: RenderOptions):
    for asked, what, item in _UNPORTED:
        if asked(opts):
            raise NotImplementedError(
                f"{what} comes with ROADMAP queue 1 item {item}")


def _zeros3(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def _ones3(n, device):
    o = torch.ones((n,), dtype=torch.float32, device=device)
    return Vec3(o, o, o)


def apply_textures(scene: SceneData, hit, params: MatParams):
    """textureModify + changeNormalDir (IIntegrator.hpp:27-127): override
    diffuse/roughness/metallic from maps and perturb the shading normal via
    the TBN frame. Returns (params, ns)."""
    ns = hit.ns
    if not scene.has_textures:
        return params, ns
    mi = torch.clamp(hit.mat, min=0).long()
    dm = scene.materials.diffuse_map[mi]
    nm = scene.materials.normal_map[mi]
    rm = scene.materials.roughness_map[mi]
    mm = scene.materials.metallic_map[mi]

    diffuse = vwhere(dm >= 0, scene.diffuse_maps.sample(dm, hit.u, hit.v),
                     params.diffuse)
    rough_tex = scene.roughness_maps.sample(rm, hit.u, hit.v).x
    roughness = torch.where(rm >= 0, rough_tex, params.roughness)
    metal_tex = scene.metallic_maps.sample(mm, hit.u, hit.v).x
    metallic = torch.where(mm >= 0, metal_tex, params.metallic)

    # normal map: decoded texel (already in [-1,1]) through TBN
    texel = scene.normal_maps.sample(nm, hit.u, hit.v)
    # triangle TBN from UV deltas (IIntegrator.hpp:45-56), precomputed per
    # triangle on the host (scene.tri_tbn)
    ti = torch.where(hit.kind == 0, torch.clamp(hit.idx, min=0), 0).long()
    tbn = scene.tri_tbn[ti]                      # [N, 6]
    t_tri = Vec3(tbn[:, 0], tbn[:, 1], tbn[:, 2])
    b_tri = Vec3(tbn[:, 3], tbn[:, 4], tbn[:, 5])
    # sphere analytic tangent (IIntegrator.hpp:67-81)
    ndir = hit.ng
    rxy = torch.sqrt(torch.clamp(ndir.x * ndir.x + ndir.y * ndir.y,
                                 min=1e-20))
    t_sph = Vec3(-ndir.y / rxy, ndir.x / rxy, torch.zeros_like(ndir.x))
    b_sph = ndir.cross(t_sph)
    is_tri = hit.kind == 0
    t_v = vwhere(is_tri, t_tri, t_sph)
    b_v = vwhere(is_tri, b_tri, b_sph)
    base_n = vwhere(is_tri, hit.ns, hit.ng)
    mapped = (t_v * texel.x + b_v * texel.y + base_n * texel.z) \
        .normalized(1e-20)
    ns = vwhere(nm >= 0, mapped, ns)

    return params._replace(diffuse=diffuse, roughness=roughness,
                           metallic=metallic), ns


def trace_rays(scene: SceneData, cam: Camera, orig: Vec3, d: Vec3,
               lane, sample_idx, seed, opts: RenderOptions,
               collect_alive: bool = False):
    """Trace one wavefront of primary rays to completion; returns per-lane
    radiance (one Monte Carlo sample per lane).

    ``collect_alive=True`` also returns an int64 tensor of the live lane
    count entering each bounce plus the lanes still pending after the loop,
    the data behind honest rays/s accounting."""
    _check_options(opts)
    n = orig.x.shape[0]
    dev = orig.x.device
    eta_scene = scene.eta
    types = scene.mtype_set

    # per-lane sample index: one sample per launch, or a vector when the
    # caller batches several spp into one wavefront
    smp = torch.broadcast_to(
        torch.as_tensor(sample_idx, dtype=torch.int32, device=dev), (n,))

    st = dict(
        o=orig, d=d,
        L=_zeros3(n, dev),
        w=_ones3(n, dev),                   # prefix weight
        tp=_ones3(n, dev),                  # RR throughput
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        from_kind=torch.full((n,), FROM_CAMERA, dtype=torch.int32,
                             device=dev),
        prev_pdf=torch.zeros((n,), dtype=torch.float32, device=dev),
        prev_mirror1=torch.zeros((n,), dtype=torch.bool, device=dev),
        w_em=_zeros3(n, dev),               # weight if next hit is emissive
        rr_inv=torch.zeros((n,), dtype=torch.float32, device=dev),
        cont_ok=torch.zeros((n,), dtype=torch.bool, device=dev),
        em_ok=torch.zeros((n,), dtype=torch.bool, device=dev),
    )

    def bounce(st, depth: int):
        o, d = st['o'], st['d']
        alive = st['alive']
        w = st['w']
        L = st['L']
        from_kind = st['from_kind']
        z3 = _zeros3(n, dev)
        one = torch.ones((n,), dtype=torch.float32, device=dev)

        u = lambda purpose: rng.uniform(seed, lane, smp, depth, purpose)

        core = intersect_core(scene, o, d, mask=alive)
        hit = shade_hit(scene, o, d, core)
        params = gather_material(scene, hit.mat)
        params, ns = apply_textures(scene, hit, params)
        hit = hit._replace(ns=ns)

        wo = -d

        # ---------- miss: bkg for camera/refract chain, nothing for BSDF
        # (the loop stops at max_depth, so every bounce is within depth)
        miss = alive & ~hit.hit
        add_bkg = miss & (from_kind != FROM_BSDF)
        L = L + vwhere(add_bkg, w * scene.bkgcolor, z3)
        alive = alive & hit.hit

        # ---------- emissive hit resolution
        emissive = params.emissive & alive
        #   camera ray: weight-1 emission (PathTracing.hpp:169-170)
        direct_em = emissive & (from_kind == FROM_CAMERA)
        L = L + vwhere(direct_em, w * params.emission, z3)
        #   BSDF-sample hit: MIS weighted (PathTracing.hpp:239-260)
        bsdf_em = emissive & (from_kind == FROM_BSDF)
        light_pdf_a = light_pdf_of_hit(scene, hit.kind, hit.idx, hit.mat,
                                       hit.area)
        cos_prime = hit.ns.normalized(1e-20).dot(-d)
        t_hit = torch.where(hit.hit, core.t, 1.0)
        r2 = t_hit * t_hit
        l_pdf_sa = light_pdf_a * r2 / torch.clamp(cos_prime, min=1e-20)
        w_m = mis_power_weight(st['prev_pdf'], l_pdf_sa)
        w_m = torch.where(st['prev_mirror1'], 1.0, w_m)
        good_em = bsdf_em & (cos_prime > 0.0) & st['em_ok'] & \
            (light_pdf_a > 0)
        w_m = torch.where(good_em, w_m, 0.0)
        L = L + vwhere(good_em, st['w_em'] * w_m * params.emission, z3)
        #   refract-chain hit on emissive: contributes 0
        #   (PathTracing.hpp:164-165)
        alive = alive & ~emissive

        # ---------- UNLIT returns diffuse (PathTracing.hpp:161)
        unlit = alive & (params.mtype == UNLIT)
        L = L + vwhere(unlit & (from_kind != FROM_BSDF), w * params.diffuse,
                       z3)
        # a BSDF-sampled UNLIT hit falls into the indirect branch; its
        # continuation returns diffuse next round, carried as w_em*rr_inv
        w_cont_prev = st['w_em'] * st['rr_inv']
        L = L + vwhere(unlit & (from_kind == FROM_BSDF) & st['cont_ok'],
                       w_cont_prev * params.diffuse, z3)
        alive = alive & ~unlit

        # ---------- indirect continuation bookkeeping for FROM_BSDF lanes
        # (RR + MIN_DIVISOR gates were evaluated at the previous vertex;
        #  apply them now that the hit is known to be non-emissive)
        from_bsdf = from_kind == FROM_BSDF
        w = vwhere(alive & from_bsdf, w_cont_prev, w)
        alive = alive & torch.where(from_bsdf, st['cont_ok'], True)

        refr = params.is_refractive_kind
        tp = st['tp']

        # ======================================================== NEE
        do_nee = alive & ~refr
        ls = sample_light(scene, u(rng.LIGHT_PICK), u(rng.LIGHT_U),
                          u(rng.LIGHT_V), opts.tutu_light_pick,
                          opts.tutu_tri_sample)
        ray_inside = hit.ns.dot(wo) < 0.0
        sh_orig = hit.pos + vwhere(ray_inside, -hit.ns, hit.ns) * EPSILON
        lpos_off = ls.pos + ls.ng * EPSILON
        to_l = lpos_off - sh_orig
        dist_l = to_l.norm()
        sh_dir = to_l * (1.0 / torch.clamp(dist_l, min=1e-20))
        blocked = occluded(scene, sh_orig, sh_dir, dist_l,
                           mask=do_nee & ls.valid)
        wi_l = ls.pos - hit.pos
        r2_l = wi_l.norm2()
        wi_l = wi_l.normalized(1e-20)
        facing = wi_l.dot(ls.ng) <= 0.0          # PathTracing.hpp:197
        cos_p = ls.ng.normalized(1e-20).dot(-wi_l)
        nee_live = do_nee & ls.valid & ~blocked & facing & (cos_p > 0.0)
        mat_pdf_l = bxdf_pdf(params, wi_l, wo, hit.ns, eta_scene,
                             params.eta, types=types)
        l_pdf_sa2 = ls.pdf_area * r2_l / torch.clamp(cos_p, min=1e-20)
        w_l = mis_power_weight(l_pdf_sa2, mat_pdf_l)
        f_r_l = bxdf_eval(params, wi_l, wo, hit.ng, hit.ns, eta_scene,
                          types=types)
        cos_t = hit.ng.dot(wi_l).abs()
        denom = r2_l * ls.pdf_area
        #   the reference kills the whole path when r2*pdf_l < MIN_DIVISOR
        kill = nee_live & (denom < MIN_DIVISOR)
        live = nee_live & ~kill
        scale = torch.where(live, w_l * cos_t * cos_p /
                            torch.clamp(denom, min=1e-20), 0.0)
        L = L + vwhere(live, w * ls.emission * f_r_l * scale, z3)
        alive = alive & ~kill

        # ======================================================== BSDF sample
        #   regular lanes (PathTracing.hpp:222-231)
        samp = bxdf_sample(params, wo, hit.ns, u(rng.BSDF_U0), u(rng.BSDF_U1),
                           u(rng.BSDF_LOTTERY), eta_scene,
                           opts.ggx_sample_bug, types=types)
        wi = samp.wi
        mat_pdf = bxdf_pdf(params, wi, wo, hit.ns, eta_scene, params.eta,
                           types=types)

        #   refractive lanes: calcForRefractive (PathTracing.hpp:80-134)
        tir = samp.tir
        wi_tir = reflect(wo, hit.ns).normalized(1e-20)
        #   MICROFACET_T TIR pdf correction (PathTracing.hpp:101-114)
        flip_r = wo.dot(hit.ng) < 0.0
        i_ns = vwhere(flip_r, -hit.ns, hit.ns)
        is_mt = params.mtype == MICROFACET_T
        eta_pass = torch.where(flip_r & is_mt & tir, params.eta, eta_scene)
        h_tir = (wo + wi_tir).normalized(1e-20)
        cos_h = i_ns.dot(h_tir).abs()
        pdf_tir_mt = d_ndf(h_tir, i_ns, params.roughness) * cos_h / \
            torch.clamp(4.0 * wo.dot(h_tir), min=1e-20)
        pdf_tir = torch.where(is_mt, pdf_tir_mt, 1.0)
        wi = vwhere(refr & tir, wi_tir, wi)
        mat_pdf = torch.where(refr & tir, pdf_tir, mat_pdf)
        eta_for_eval = torch.where(refr, eta_pass, eta_scene)
        eta_for_eval = torch.where(refr & ~tir, eta_scene, eta_for_eval)

        f_r = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_for_eval,
                        adjoint=False, tir=refr & tir)

        fail = alive & ~refr & ~samp.success
        alive = alive & (refr | samp.success)

        cos_n = hit.ng.dot(wi).abs()

        #   RR draw happens at this vertex (PathTracing.hpp:263-268)
        tp_eff = tp if depth > opts.min_depth else _ones3(n, dev)
        rr_prob = torch.clamp(tp_eff.max_component(), 0.0, 1.0) \
            if opts.russian_roulette else one
        rr_survive = u(rng.RR) <= rr_prob

        # zero the inverse pdf below its kill threshold
        inv_pdf = torch.where(mat_pdf >= MIN_DIVISOR,
                              1.0 / torch.clamp(mat_pdf, min=1e-20), 0.0)
        base = f_r * (cos_n * inv_pdf)
        em_ok = mat_pdf >= MIN_DIVISOR
        cont_ok = rr_survive & (mat_pdf * rr_prob >= MIN_DIVISOR)
        rr_inv = torch.where(rr_prob > 0.0,
                             1.0 / torch.clamp(rr_prob, min=1e-20), 0.0)
        coe = base * rr_inv

        #   refractive lanes: no NEE/RR; gate pdf >= MIN_DIVISOR, reset tp
        refr_ok = mat_pdf >= MIN_DIVISOR

        new_from = torch.where(refr, FROM_REFRACT, FROM_BSDF).to(torch.int32)
        w_em = w * base
        w_next = vwhere(refr, w * base, w)
        tp_next = vwhere(refr, _ones3(n, dev), tp_eff * coe)

        alive_next = alive & torch.where(refr, refr_ok, True)
        # non-refractive lanes stay "alive" into the next bounce even if
        # cont_ok is false, because the emissive-hit strategy (em_ok) may
        # still pay out; fully dead only if both gates fail
        alive_next = alive_next & torch.where(refr, True, em_ok | cont_ok)

        ray_o = hit.pos + vwhere(wi.dot(hit.ns) < 0.0, -hit.ns, hit.ns) * \
            EPSILON

        return dict(
            o=ray_o, d=wi, L=L, w=w_next, tp=tp_next,
            alive=alive_next & ~fail,
            from_kind=new_from,
            prev_pdf=mat_pdf,
            prev_mirror1=(params.mtype == PERFECT_REFLECTIVE) &
            (mat_pdf == 1.0),
            w_em=w_em, rr_inv=rr_inv,
            cont_ok=cont_ok & alive, em_ok=em_ok & alive,
        )

    def epilogue(st):
        """Resolve the final pending BSDF-sample emissive hit (recursion
        depth max_depth+1, where traceRay returns 0 for everything else,
        PathTracing.hpp:140): one intersection, no NEE/sampling."""
        L = st['L']
        pending = st['alive'] & (st['from_kind'] == FROM_BSDF)
        core = intersect_core(scene, st['o'], st['d'], mask=pending)
        hit = shade_hit(scene, st['o'], st['d'], core)
        params = gather_material(scene, hit.mat)
        emissive = params.emissive & pending & hit.hit
        light_pdf_a = light_pdf_of_hit(scene, hit.kind, hit.idx, hit.mat,
                                       hit.area)
        cos_prime = hit.ns.normalized(1e-20).dot(-st['d'])
        t_hit = torch.where(hit.hit, core.t, 1.0)
        l_pdf_sa = light_pdf_a * t_hit * t_hit / \
            torch.clamp(cos_prime, min=1e-20)
        w_m = mis_power_weight(st['prev_pdf'], l_pdf_sa)
        w_m = torch.where(st['prev_mirror1'], 1.0, w_m)
        good = emissive & (cos_prime > 0.0) & st['em_ok'] & (light_pdf_a > 0)
        w_m = torch.where(good, w_m, 0.0)
        return L + vwhere(good, st['w_em'] * w_m * params.emission,
                          _zeros3(n, dev))

    counts = []
    for depth in range(opts.max_depth + 1):
        if collect_alive:
            counts.append(st['alive'].sum())
        st = bounce(st, depth)
    if collect_alive:
        counts.append(st['alive'].sum())
        return epilogue(st), torch.stack(counts)
    return epilogue(st)


def render_sample(scene: SceneData, cam: Camera, px, py, lane, sample_idx,
                  seed, opts: RenderOptions) -> Vec3:
    if opts.jitter:
        jx = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JX)
        jy = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JY)
        o, d, _ = primary_ray(cam, px, py, jx, jy)
    else:
        o, d, _ = primary_ray(cam, px, py)
    L = trace_rays(scene, cam, o, d, lane, sample_idx, seed, opts)
    # NaN sample rejection (PathTracing.hpp:510-511)
    bad = torch.isnan(L.x) | torch.isnan(L.y) | torch.isnan(L.z)
    return vwhere(bad, _zeros3(px.shape[0], px.device), L)


def _block_order(width: int, height: int, block: int = 32):
    """Pixel visit order in (block x block) screen tiles, as the JAX
    package emits its lanes (the RNG is keyed by pixel, so the order does
    not change the image)."""
    ys, xs = np.mgrid[0:height, 0:width]
    bw = -(-width // block)
    key = ((ys // block) * bw + (xs // block)) * (block * block) \
        + (ys % block) * block + (xs % block)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


def render(scene: SceneData, cam: Camera, opts: RenderOptions, seed=0,
           sample_base=0) -> torch.Tensor:
    """Full-frame render -> [H, W, 3] linear radiance on the scene's
    device. ``sample_base`` shifts the global sample indices so chunked
    renders continue the exact stream.

    Lanes are emitted in 32x32 screen-block order, and
    ``opts.samples_per_launch`` > 1 batches that many spp into one
    wavefront (lane = (sample, blocked pixel)); the per-pixel sums are those
    of the one-sample row-major schedule."""
    _check_options(opts)
    dev = scene.device
    p = cam.n_pixels
    order_np = _block_order(cam.width, cam.height)
    order = torch.from_numpy(order_np).to(dev)
    # the film accumulates in lane order and unpermutes once at the end
    inv_order = torch.from_numpy(np.argsort(order_np)).to(dev)
    sb = max(1, min(opts.samples_per_launch or 1, opts.spp))
    while opts.spp % sb:
        sb -= 1
    pix = order.repeat(sb)                         # [p*sb] pixel id per lane
    px = pix % cam.width
    py = pix // cam.width
    soff = torch.arange(sb, dtype=torch.int32, device=dev) \
        .repeat_interleave(p)

    acc = [torch.zeros((p * sb,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    for s in range(opts.spp // sb):
        L = render_sample(scene, cam, px, py, pix, sample_base + s * sb + soff,
                          seed, opts)
        acc = [acc[0] + L.x, acc[1] + L.y, acc[2] + L.z]
    inv = 1.0 / opts.spp
    img = torch.stack([a.reshape(sb, p).sum(dim=0) * inv for a in acc],
                      dim=-1)
    return img[inv_order.long()].reshape(cam.height, cam.width, 3)
