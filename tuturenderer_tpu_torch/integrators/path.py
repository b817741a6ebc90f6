"""Wavefront unidirectional path tracer with NEE + power-heuristic MIS.

The port of ``tuturenderer_tpu/integrators/path.py``. One wavefront of
lanes is traced through a Python loop of ``max_depth + 1`` bounces and an
epilogue; per-material virtual calls are masked blends and finished lanes
carry a dead mask. The estimator is the reference's recursive
``traceRay`` (PathTracing.hpp:136-349):

- camera rays through pixel centers (PathTracing.hpp:377-391, 444);
- at each vertex: NEE light sample with solid-angle-converted MIS weight
  (PathTracing.hpp:180-219), BSDF sample with the mirrored MIS weight on
  emissive hits (PathTracing.hpp:222-261), Russian roulette gated by
  MIN_DEPTH on the running throughput (PathTracing.hpp:263-277);
- PERFECT_REFRACTIVE / MICROFACET_T vertices take the dielectric path with
  TIR handling (calcForRefractive, PathTracing.hpp:80-134), which skips NEE
  and resets the RR throughput;
- MIN_DIVISOR kill thresholds reproduced (PathTracing.hpp:215, 257, 272).

``mis=False`` takes the NEE-only estimator of the reference's !MIS branch
(PathTracing.hpp:281-347). ``alpha_shadows`` replaces the shadow any hit
with the alpha-weighted transmittance in either estimator.

``differentiable=True`` gives detached-sampling autodiff (``grad.py``): at
every site where the JAX package applies ``stop_gradient`` (sampled
directions, light points, pdfs, MIS weights and Russian-roulette
probabilities) the port applies ``.detach()``, so gradients flow only
through BSDF values, emission and cosine terms. Each bounce then runs
under a non-reentrant ``torch.utils.checkpoint`` (the JAX package's
per-bounce ``jax.checkpoint``): the backward pass recomputes a bounce from
its carried state instead of keeping its [N]-wide intermediates. A
recomputed bounce draws the same numbers (the RNG is a pure hash) and
launches its kernels again.

Each bounce makes one nearest-hit and one shadow call, so a sample launches
the nearest-hit kernel (max_depth + 2) times and the any-hit (or, under
``alpha_shadows``, the transmittance) kernel (max_depth + 1) times: the
dense kernels on a dense scene, the cluster kernels on a scene with
cluster tables. The JAX package keeps a cluster scene's wavefront sorted in
octant-Morton order for its TPU tiles; the port traces it unsorted, so
lanes stay in the caller's order.

``compaction`` (a per-bounce schedule of live-lane fractions) shrinks the
wavefront between bounces, the JAX package's unsorted branch: every lane
flushes its radiance into a full-width film keyed by its original lane,
then the live lanes, ordered by a random key per lane (dead lanes last),
fill the narrower wavefront. When more lanes are live than fit, that key
picks a uniformly random subset, whose weights are scaled by live/kept, so
the estimate stays unbiased; the number of live lanes dropped so is
counted on the device (``collect_overflow``, ``render(stats=True)``).
A shrink launches no kernel, so the launch counts are those above.

Under ``utils/profiling.py``'s spans, ``render`` is a unit with a
``render.sample`` span a sample batch, and ``trace_rays`` opens one
``bounce`` span a bounce (counting its depth; a checkpointed bounce opens
it again when the backward pass recomputes it), ``bounce.epilogue`` and
``bounce.compact``; the queries, shading and draws inside open their own.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint

from ..camera import Camera, primary_ray
from ..materials import (MatParams, bxdf_eval, bxdf_pdf, bxdf_sample,
                         d_ndf, gather_material, mis_power_weight)
from ..ops.intersect import (intersect_core, occluded, shade_hit,
                             transmittance)
from ..ops.lights import light_pdf_of_hit, sample_light
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..scene.data import (MICROFACET_T, PERFECT_REFLECTIVE, UNLIT, SceneData)
from ..utils import rng
from ..utils.profiling import live_lanes, span, spanned, unit
from ..utils.vec import Vec3, reflect, where as vwhere

# lane provenance at loop top (what produced the current ray)
FROM_CAMERA = 0
FROM_BSDF = 1       # BSDF sample of a non-refractive vertex (MIS pending)
FROM_REFRACT = 2    # calcForRefractive continuation
FROM_MIRROR = 3     # NEE-only mode: calcForMirror continuation
FROM_INDIRECT = 4   # NEE-only mode: indirect-illumination continuation

def _detacher(opts: RenderOptions):
    """The JAX package's ``sg``: ``.detach()`` of a tensor or a Vec3 when
    ``opts.differentiable`` is set, else the identity."""
    if not opts.differentiable:
        return lambda x: x
    return lambda x: Vec3(*(c.detach() for c in x)) if isinstance(x, Vec3) \
        else x.detach()


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint that the backward pass
    re-runs whole (early stop off), so a recomputation launches exactly the
    kernels the forward call did. ``fn`` draws no numbers from torch's
    generators, so their state is not kept."""
    with checkpoint.set_checkpoint_early_stop(False):
        return checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                     preserve_rng_state=False)


def _zeros3(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def _ones3(n, device):
    o = torch.ones((n,), dtype=torch.float32, device=device)
    return Vec3(o, o, o)


@spanned("shade.material")
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
               collect_alive: bool = False, collect_overflow: bool = False):
    """Trace one wavefront of primary rays to completion; returns per-lane
    radiance (one Monte Carlo sample per lane).

    ``collect_alive=True`` (without compaction) also returns an int64
    tensor of the live lane count entering each bounce plus the lanes
    still pending after the loop, the data behind honest rays/s
    accounting. ``collect_overflow=True`` also returns the number of live
    lanes the compaction roulette dropped (and compensated for), an int32
    0-d tensor on the device."""
    n = orig.x.shape[0]
    dev = orig.x.device
    eta_scene = scene.eta
    types = scene.mtype_set
    sg = _detacher(opts)

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
        **_lane_keys(lane, smp),
    )

    def bounce(st, depth: int):
        o, d = st['o'], st['d']
        alive = st['alive']
        w = st['w']
        L = st['L']
        from_kind = st['from_kind']
        nn = o.x.shape[0]                   # the (possibly compacted) width
        z3 = _zeros3(nn, dev)
        one = torch.ones((nn,), dtype=torch.float32, device=dev)

        u = lambda purpose: rng.uniform(seed, st['lane'], st['smp'], depth,
                                        purpose)

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
        w_m = sg(mis_power_weight(st['prev_pdf'], l_pdf_sa))
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
        ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng),
                         pdf_area=sg(ls.pdf_area))
        ray_inside = hit.ns.dot(wo) < 0.0
        sh_orig = hit.pos + vwhere(ray_inside, -hit.ns, hit.ns) * EPSILON
        lpos_off = ls.pos + ls.ng * EPSILON
        to_l = lpos_off - sh_orig
        dist_l = to_l.norm()
        sh_dir = to_l * (1.0 / torch.clamp(dist_l, min=1e-20))
        sh_trans, blocked = _shadow(scene, sh_orig, sh_dir, dist_l,
                                    do_nee & ls.valid, opts)
        wi_l = ls.pos - hit.pos
        r2_l = wi_l.norm2()
        wi_l = wi_l.normalized(1e-20)
        facing = wi_l.dot(ls.ng) <= 0.0          # PathTracing.hpp:197
        cos_p = ls.ng.normalized(1e-20).dot(-wi_l)
        nee_live = do_nee & ls.valid & ~blocked & facing & (cos_p > 0.0)
        mat_pdf_l = sg(bxdf_pdf(params, wi_l, wo, hit.ns, eta_scene,
                                params.eta, types=types))
        l_pdf_sa2 = ls.pdf_area * r2_l / torch.clamp(cos_p, min=1e-20)
        w_l = sg(mis_power_weight(l_pdf_sa2, mat_pdf_l))
        f_r_l = bxdf_eval(params, wi_l, wo, hit.ng, hit.ns, eta_scene,
                          types=types)
        cos_t = hit.ng.dot(wi_l).abs()
        denom = r2_l * ls.pdf_area
        #   the reference kills the whole path when r2*pdf_l < MIN_DIVISOR
        kill = nee_live & (denom < MIN_DIVISOR)
        live = nee_live & ~kill
        scale = torch.where(live, w_l * cos_t * cos_p /
                            torch.clamp(denom, min=1e-20), 0.0)
        if sh_trans is not None:
            scale = scale * sh_trans
        L = L + vwhere(live, w * ls.emission * f_r_l * scale, z3)
        alive = alive & ~kill

        # ======================================================== BSDF sample
        #   regular lanes (PathTracing.hpp:222-231)
        samp = bxdf_sample(params, wo, hit.ns, u(rng.BSDF_U0), u(rng.BSDF_U1),
                           u(rng.BSDF_LOTTERY), eta_scene,
                           opts.ggx_sample_bug, types=types)
        samp = samp._replace(wi=sg(samp.wi))
        wi = samp.wi
        mat_pdf = sg(bxdf_pdf(params, wi, wo, hit.ns, eta_scene, params.eta,
                              types=types))

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
        mat_pdf = torch.where(refr & tir, sg(pdf_tir), mat_pdf)
        eta_for_eval = torch.where(refr, eta_pass, eta_scene)
        eta_for_eval = torch.where(refr & ~tir, eta_scene, eta_for_eval)

        f_r = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_for_eval,
                        adjoint=False, tir=refr & tir)

        fail = alive & ~refr & ~samp.success
        alive = alive & (refr | samp.success)

        cos_n = hit.ng.dot(wi).abs()

        #   RR draw happens at this vertex (PathTracing.hpp:263-268)
        tp_eff = tp if depth > opts.min_depth else _ones3(nn, dev)
        rr_prob = sg(torch.clamp(tp_eff.max_component(), 0.0, 1.0)) \
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
        tp_next = vwhere(refr, _ones3(nn, dev), tp_eff * coe)

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
            lane=st['lane'], smp=st['smp'], fkey=st['fkey'],
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
        w_m = sg(mis_power_weight(st['prev_pdf'], l_pdf_sa))
        w_m = torch.where(st['prev_mirror1'], 1.0, w_m)
        good = emissive & (cos_prime > 0.0) & st['em_ok'] & (light_pdf_a > 0)
        w_m = torch.where(good, w_m, 0.0)
        return L + vwhere(good, st['w_em'] * w_m * params.emission,
                          _zeros3(st['o'].x.shape[0], dev))

    if not opts.mis:
        st = dict(o=orig, d=d, L=_zeros3(n, dev), w=_ones3(n, dev),
                  tp=_ones3(n, dev),
                  alive=torch.ones((n,), dtype=torch.bool, device=dev),
                  from_kind=torch.full((n,), FROM_CAMERA, dtype=torch.int32,
                                       device=dev),
                  **_lane_keys(lane, smp))
        bounce = functools.partial(_nee_bounce, scene, seed, opts)
        # nothing pays at depth max_depth+1: traceRay returns 0 before the
        # miss/emissive checks (PathTracing.hpp:140), and the NEE branch has
        # no pending emissive strategy
        epilogue = lambda st: st['L']

    bounce = _bounce_span(bounce)
    epilogue = spanned("bounce.epilogue")(epilogue)
    step = functools.partial(_remat, bounce) if opts.differentiable \
        else bounce
    if opts.compaction:
        if collect_alive:
            raise ValueError("collect_alive counts the uncompacted "
                             "wavefront: pass compaction=()")
        out, over = _compacted(st, step, epilogue, seed, opts)
        return (out, over) if collect_overflow else out

    counts = []
    for depth in range(opts.max_depth + 1):
        if collect_alive:
            counts.append(live_lanes(st['alive']))
        st = step(st, depth)
    if collect_alive:
        counts.append(live_lanes(st['alive']))
        return epilogue(st), torch.stack(counts)
    if collect_overflow:
        return epilogue(st), torch.zeros((), dtype=torch.int32, device=dev)
    return epilogue(st)


def _bounce_span(fn):
    """``fn(st, depth)`` inside a ``bounce`` span that counts its
    depth."""
    def run(st, depth: int):
        with span("bounce") as sp:
            sp.count("depth", depth)
            return fn(st, depth)
    return run


def _lane_keys(lane, smp) -> dict:
    """The per-lane keys a state carries through compaction: the lane and
    sample ids every draw is keyed by, and the film slot (``fkey``) the
    lane's radiance is flushed to."""
    n = lane.shape[0]
    return dict(lane=lane, smp=smp,
                fkey=torch.arange(n, dtype=torch.int32, device=lane.device))


def seg_width(n: int, frac: float) -> int:
    """The wavefront width of a schedule fraction: ``n * frac`` rounded up
    to a multiple of 1024 lanes, at most ``n``."""
    return min(int(-(-int(n * frac) // 1024) * 1024), n)


def _segments(opts: RenderOptions):
    """[(fraction, [depths])]: consecutive bounces of one schedule fraction
    (the last fraction repeats past the schedule's end)."""
    segments = []
    sched = opts.compaction
    for depth in range(opts.max_depth + 1):
        frac = sched[depth] if depth < len(sched) else sched[-1]
        if segments and segments[-1][0] == frac:
            segments[-1][1].append(depth)
        else:
            segments.append((frac, [depth]))
    return segments


def _flush(film: torch.Tensor, st) -> torch.Tensor:
    """``film`` [n, 3] plus each lane's radiance at its film slot."""
    return film.index_add(0, st['fkey'].long(),
                          torch.stack(tuple(st['L']), dim=-1))


@spanned("bounce.compact")
def _compact(st, film, k: int, depth: int, seed):
    """Shrink the wavefront to ``k`` lanes: flush every lane's radiance
    into the film, order the lanes by their roulette key (a uniform draw
    per live lane, 2.0 for a dead one; a stable sort, as ``jnp.argsort``)
    and keep the first ``k``, their radiance reset. With more than ``k``
    live lanes the kept ones carry weights scaled by live/k, which keeps
    the estimate unbiased. Returns (state, film, live lanes dropped); the
    count stays on the device."""
    alive = st['alive']
    cnt = alive.sum(dtype=torch.int32)
    film = _flush(film, st)
    pri = rng.uniform(seed, st['lane'], st['smp'], depth, rng.COMPACT)
    key = torch.where(alive, pri, 2.0)
    keep = torch.argsort(key, stable=True)[:k]
    new = {name: (Vec3(*(c[keep] for c in v)) if isinstance(v, Vec3)
                  else v[keep]) for name, v in st.items()}
    dev = keep.device
    new['L'] = _zeros3(k, dev)
    new['alive'] = new['alive'] & \
        (torch.arange(k, dtype=torch.int32, device=dev) < cnt)
    factor = torch.where(cnt > k, cnt.to(torch.float32) / k, 1.0)
    # scaling w and w_em also scales the continuation weight w_em * rr_inv,
    # so the upweight covers every later payout
    for name in ('w', 'w_em'):
        if name in new:
            new[name] = new[name] * factor
    return new, film, torch.clamp(cnt - k, min=0)


def _compacted(st, step, epilogue, seed, opts: RenderOptions):
    """The bounce loop under ``opts.compaction``: each segment of the
    schedule that narrows the wavefront starts with a shrink. Returns
    (per-lane radiance at the original lanes, live lanes dropped)."""
    n = st['o'].x.shape[0]
    dev = st['o'].x.device
    film = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    over = torch.zeros((), dtype=torch.int32, device=dev)
    for frac, depths in _segments(opts):
        k = seg_width(n, frac)
        if k < st['o'].x.shape[0]:
            st, film, dropped = _compact(st, film, k, depths[0], seed)
            over = over + dropped
        for depth in depths:
            st = step(st, depth)
    film = _flush(film, dict(fkey=st['fkey'], L=epilogue(st)))
    return Vec3(film[:, 0], film[:, 1], film[:, 2]), over


def _shadow(scene: SceneData, sh_orig: Vec3, sh_dir: Vec3, dist, mask,
            opts: RenderOptions):
    """The NEE shadow query -> (transmittance or None, blocked). With
    ``alpha_shadows`` visibility is the product of (1 - alpha) over every
    occluder (getShadowCoeffi, BVHStrategy.hpp:13-45), else an any hit."""
    if opts.alpha_shadows:
        sh_trans = transmittance(scene, sh_orig, sh_dir, dist, mask=mask)
        return sh_trans, sh_trans <= 0.0
    return None, occluded(scene, sh_orig, sh_dir, dist, mask=mask)


def _nee_bounce(scene: SceneData, seed, opts: RenderOptions, st,
                depth: int):
    """One bounce of the NEE-only estimator (the reference's !MIS branch,
    PathTracing.hpp:281-347): light sampling is the only direct-light
    strategy, so emission is seen only on camera rays. Perfect mirrors take
    calcForMirror (PathTracing.hpp:50-70), an unweighted recursion through
    the delta reflection; refractives take calcForRefractive as in the MIS
    branch. Each vertex commits its NEE contribution inline, continuations
    carry a prefix weight, and the child vertex resolves the parent's
    "intersected && non-emissive" recursion gate (PathTracing.hpp:337)."""
    o, d = st['o'], st['d']
    alive = st['alive']
    w = st['w']
    L = st['L']
    from_kind = st['from_kind']
    n = o.x.shape[0]
    dev = o.x.device
    eta_scene = scene.eta
    types = scene.mtype_set
    sg = _detacher(opts)
    z3 = _zeros3(n, dev)
    one = torch.ones((n,), dtype=torch.float32, device=dev)

    u = lambda purpose: rng.uniform(seed, st['lane'], st['smp'], depth,
                                    purpose)

    core = intersect_core(scene, o, d, mask=alive)
    hit = shade_hit(scene, o, d, core)
    params = gather_material(scene, hit.mat)
    params, ns = apply_textures(scene, hit, params)
    hit = hit._replace(ns=ns)
    wo = -d

    # miss: bkgcolor for camera rays and refractive continuations
    # (traceRay:150); a missed mirror ray returns 0 (calcForMirror checks
    # x_inter before recursing, PathTracing.hpp:59-68); the indirect
    # recursion is handed a known hit so it cannot miss
    miss = alive & ~hit.hit
    add_bkg = miss & ((from_kind == FROM_CAMERA) |
                      (from_kind == FROM_REFRACT))
    L = L + vwhere(add_bkg, w * scene.bkgcolor, z3)
    alive = alive & hit.hit

    # emissive: weight-1 on camera rays; every depth>0 provenance returns 0
    # (traceRay:163-170; the indirect recursion never enters emissive hits,
    # PathTracing.hpp:337)
    emissive = params.emissive & alive
    L = L + vwhere(emissive & (from_kind == FROM_CAMERA),
                   w * params.emission, z3)
    alive = alive & ~emissive

    refr = params.is_refractive_kind
    mirror = params.mtype == PERFECT_REFLECTIVE

    # UNLIT returns diffuse from any provenance (the indirect recursion
    # enters non-emissive hits; UNLIT qualifies)
    unlit = alive & (params.mtype == UNLIT)
    L = L + vwhere(unlit, w * params.diffuse, z3)
    alive = alive & ~unlit

    diff = alive & ~refr & ~mirror
    tp = st['tp']

    # ---- direct illumination (NEE, PathTracing.hpp:287-312): no MIS
    # weight, no MIN_DIVISOR kill; the shadow offset uses Ng and the
    # light's Ng gives cos_theta_prime, and cos_theta = wi.Ns is SIGNED
    ls = sample_light(scene, u(rng.LIGHT_PICK), u(rng.LIGHT_U),
                      u(rng.LIGHT_V), opts.tutu_light_pick,
                      opts.tutu_tri_sample)
    ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng), pdf_area=sg(ls.pdf_area))
    ray_inside = hit.ng.dot(wo) < 0.0          # Ng (PathTracing.hpp:293)
    sh_orig = hit.pos + vwhere(ray_inside, -hit.ng, hit.ng) * EPSILON
    to_l = ls.pos - sh_orig                    # light position not offset
    dist_l = to_l.norm()
    sh_dir = to_l * (1.0 / torch.clamp(dist_l, min=1e-20))
    sh_trans, blocked = _shadow(scene, sh_orig, sh_dir, dist_l,
                                diff & ls.valid, opts)
    p2l = (ls.pos - hit.pos).normalized(1e-20)
    cos_p = ls.ng.normalized(1e-20).dot(-p2l)
    cos_t = p2l.dot(hit.ns)                    # signed (hpp:306)
    dis2 = (ls.pos - hit.pos).norm2()
    f_r_l = bxdf_eval(params, p2l, wo, hit.ng, hit.ns, eta_scene,
                      types=types)
    # cos_theta_prime < 0 rejected, == 0 kept (hpp:300)
    dir_live = diff & ls.valid & ~blocked & (cos_p >= 0.0)
    denom = torch.clamp(dis2 * ls.pdf_area, min=1e-20)
    dir_scale = torch.where(dir_live, cos_t * cos_p / denom, 0.0)
    if sh_trans is not None:
        dir_scale = dir_scale * sh_trans
    dir_illu = ls.emission * f_r_l * dir_scale

    # ---- RR before sampling (hpp:315-319)
    tp_eff = tp if depth > opts.min_depth else _ones3(n, dev)
    rr_prob = sg(torch.clamp(tp_eff.max_component(), 0.0, 1.0)) \
        if opts.russian_roulette else one
    rr_survive = u(rng.RR) <= rr_prob

    # ---- BSDF sample (shared by the mirror / refractive / indirect cases)
    samp = bxdf_sample(params, wo, hit.ns, u(rng.BSDF_U0), u(rng.BSDF_U1),
                       u(rng.BSDF_LOTTERY), eta_scene, opts.ggx_sample_bug,
                       types=types)
    samp = samp._replace(wi=sg(samp.wi))
    wi = samp.wi
    mat_pdf = sg(bxdf_pdf(params, wi, wo, hit.ns, eta_scene, params.eta,
                          types=types))

    # refractive lanes: calcForRefractive, identical to the MIS mode
    tir = samp.tir
    wi_tir = reflect(wo, hit.ns).normalized(1e-20)
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
    mat_pdf = torch.where(refr & tir, sg(pdf_tir), mat_pdf)
    eta_for_eval = torch.where(refr, eta_pass, eta_scene)
    eta_for_eval = torch.where(refr & ~tir, eta_scene, eta_for_eval)
    f_r = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_for_eval,
                    adjoint=False, tir=refr & tir, types=types)

    # commit dir_illu: a failed RR draw or a failed BSDF sample returns
    # sampleValue=0 BEFORE dir_illu is added: the reference quirk that
    # Russian roulette also kills the direct light already computed
    # (PathTracing.hpp:317-327)
    commit = dir_live & rr_survive & samp.success
    L = L + vwhere(commit, w * dir_illu, z3)

    # ---- per-case continuation weights
    inv_pdf = torch.where(mat_pdf >= MIN_DIVISOR,
                          1.0 / torch.clamp(mat_pdf, min=1e-20), 0.0)
    #   mirror: res * f_r * (Ng.wi signed) / pdf, no RR, no divisor gate
    #   (calcForMirror:60-66); pdf is 1 for the delta mirror
    cos_mirror = hit.ng.dot(wi)
    w_mirror = w * f_r * (cos_mirror / torch.clamp(mat_pdf, min=1e-20))
    #   refractive: Li * cos * f_r / pdf with pdf >= MIN_DIVISOR
    cos_refr = hit.ng.dot(wi).abs()
    w_refr = w * f_r * (cos_refr * inv_pdf)
    #   indirect: coe = f_r * |Ns.wi| / (pdf * rr_prob), gated by
    #   pdf*rr_prob >= MIN_DIVISOR (hpp:335-343)
    cos_ind = hit.ns.dot(wi).abs()
    pdf_rr = mat_pdf * rr_prob
    inv_pdf_rr = torch.where(pdf_rr >= MIN_DIVISOR,
                             1.0 / torch.clamp(pdf_rr, min=1e-20), 0.0)
    coe = f_r * (cos_ind * inv_pdf_rr)

    new_from = torch.where(refr, FROM_REFRACT,
                           torch.where(mirror, FROM_MIRROR, FROM_INDIRECT)) \
        .to(torch.int32)
    w_next = vwhere(refr, w_refr, vwhere(mirror, w_mirror, w * coe))
    #   mirror and refractive recursions reset tp to 1 (calcForMirror:65,
    #   calcForRefractive:130)
    tp_next = vwhere(diff, tp_eff * coe, _ones3(n, dev))

    alive_next = alive & torch.where(
        refr, mat_pdf >= MIN_DIVISOR,
        torch.where(mirror, True,
                    rr_survive & samp.success & (pdf_rr >= MIN_DIVISOR)))

    #   ray origins: indirect offsets along +-Ng (hpp:331-333), refractive
    #   along +-Ns (calcForRefractive:118-126), mirror always +Ns
    #   (calcForMirror:57)
    ray_o_diff = hit.pos + vwhere(wi.dot(hit.ng) < 0.0, -hit.ng, hit.ng) * \
        EPSILON
    ray_o_refr = hit.pos + vwhere(wi.dot(hit.ns) < 0.0, -hit.ns, hit.ns) * \
        EPSILON
    ray_o_mirr = hit.pos + hit.ns * EPSILON
    ray_o = vwhere(refr, ray_o_refr, vwhere(mirror, ray_o_mirr, ray_o_diff))

    return dict(o=ray_o, d=wi, L=L, w=w_next, tp=tp_next, alive=alive_next,
                from_kind=new_from, lane=st['lane'], smp=st['smp'],
                fkey=st['fkey'])


def render_sample(scene: SceneData, cam: Camera, px, py, lane, sample_idx,
                  seed, opts: RenderOptions, collect_overflow: bool = False):
    """Per-lane radiance of one sample (a NaN sample counts as 0), and with
    ``collect_overflow`` the compaction roulette's dropped-lane count."""
    with span("render.sample"):
        return _render_sample(scene, cam, px, py, lane, sample_idx, seed,
                              opts, collect_overflow)


def _render_sample(scene, cam, px, py, lane, sample_idx, seed, opts,
                   collect_overflow):
    if opts.jitter:
        jx = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JX)
        jy = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JY)
        o, d, _ = primary_ray(cam, px, py, jx, jy)
    else:
        o, d, _ = primary_ray(cam, px, py)
    out = trace_rays(scene, cam, o, d, lane, sample_idx, seed, opts,
                     collect_overflow=collect_overflow)
    L, over = out if collect_overflow else (out, None)
    # NaN sample rejection (PathTracing.hpp:510-511)
    bad = torch.isnan(L.x) | torch.isnan(L.y) | torch.isnan(L.z)
    L = vwhere(bad, _zeros3(px.shape[0], px.device), L)
    return (L, over) if collect_overflow else L


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
           sample_base=0, stats: bool = False):
    """Full-frame render -> [H, W, 3] linear radiance on the scene's
    device. ``sample_base`` shifts the global sample indices so chunked
    renders continue the exact stream.

    Lanes are emitted in 32x32 screen-block order, and
    ``opts.samples_per_launch`` > 1 batches that many spp into one
    wavefront (lane = (sample, blocked pixel)); the per-pixel sums are those
    of the one-sample row-major schedule.

    ``stats=True`` returns (img, {"compaction_overflow": int32 0-d tensor
    on the device}): the live lanes the compaction roulette dropped over
    the whole render, which the caller reads after its own sync."""
    with unit("render"):
        return _render(scene, cam, opts, seed, sample_base, stats)


def _render(scene, cam, opts, seed, sample_base, stats):
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
    over = torch.zeros((), dtype=torch.int32, device=dev)
    for s in range(opts.spp // sb):
        L, dropped = render_sample(scene, cam, px, py, pix,
                                   sample_base + s * sb + soff, seed, opts,
                                   collect_overflow=True)
        acc = [acc[0] + L.x, acc[1] + L.y, acc[2] + L.z]
        over = over + dropped
    inv = 1.0 / opts.spp
    img = torch.stack([a.reshape(sb, p).sum(dim=0) * inv for a in acc],
                      dim=-1)
    img = img[inv_order.long()].reshape(cam.height, cam.width, 3)
    if stats:
        return img, {"compaction_overflow": over}
    return img
