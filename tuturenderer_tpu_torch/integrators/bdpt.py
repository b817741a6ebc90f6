"""Bidirectional path tracing with per-strategy power-heuristic MIS.

The port of ``tuturenderer_tpu/integrators/bdpt.py`` (BDPT.hpp:59-900):

- the eye and light subpaths are built by Python loops of static depth into
  per-vertex dicts of [N] tensors (the reference's ``eyePathVert`` vectors,
  BDPT.hpp:34-57); a validity mask per vertex replaces its early
  ``break``/``return``;
- the strategies (pathLength 1..MAX, s in 0..pathLength, BDPT.hpp:752-887)
  are a static double loop, so every MIS chain (BDPT.hpp:70-222) unrolls
  with static s, t; only per-lane validity is masked;
- t=1 light-tracing splats (the reference's addRGB under a lock,
  BDPT.hpp:819-832) go into films of ``p + 1`` slots by ``index_add_``, as
  in ``integrators/light.py``: an off-film splat writes slot ``p``, which is
  sliced off, so no lane is filtered with a host sync.

Semantics kept from the JAX package: projected-solid-angle vertex pdfs,
delta vertices skipped in the MIS chain (Veach 10.3.5, BDPT.hpp:193-216),
the light pick pdf stashed in the light vertex's ``rev`` (BDPT.hpp:309),
the connection-end pdfs re-derived for s=0, t=1, s=1 and the general case
(BDPT.hpp:82-142), the NaN/inf weight kill and, under
``tutu_bdpt_weight_kill``, the MIN_DIVISOR kill (BDPT.hpp:218-219), the
s=1 orientation gate (BDPT.hpp:848-852), an UNLIT first hit counted once
under (s=0, t=2), and, under ``tutu_bdpt_t1_gate``, the t=1 splats of a
lane whose camera ray missed dropped (BDPT.hpp:733-734).

Every strategy's connection shadow ray is queued and all are traced in one
``occluded`` call over K * N rays (K = 27 at the default
``bdpt_max_path_length`` 7); the BSDF evaluations and connection-end pdfs
of every strategy are queued too and resolved by three stacked material
calls. Per launch that is ``bdpt_max_path_length`` eye steps and
``bdpt_max_path_length - 1`` light steps, one nearest-hit call each (13 at
the default), and one shadow call. The JAX package sorts nothing here
either: the stacked shadow rays go to the kernel in queue order.

Under ``utils/profiling.py``'s spans, ``render`` is a unit (the path
tracer's name), ``build_eye_path`` and ``build_light_path`` are
``bdpt.eye`` and ``bdpt.light`` spans, the strategies of a wavefront (the
MIS chains, the queued requests and their stacked material calls, the one
shadow call) a ``bdpt.connect`` span that counts the queued connection
rays (``rays``, K * N) and, while recording, the valid ones (``live``, a
0-d device tensor), and the films' splats a ``bdpt.splat`` span that
counts those that land on the film (``splats``, 0-d).

``BDPTFrame`` is the schedule of a render (``integrators/frame.py``),
which ``render`` and ``grad.render_bdpt_diff`` run. On the card,
``render`` replays each wavefront from a CUDA graph
(``utils/cuda_graph.py::run``): the ~22,300 launches of a 1,048,576-lane
wavefront at length 7 would otherwise each be dispatched by the host,
which then sets the pace. The rules for when a wavefront runs eagerly are
``run``'s. The image is the eager one's up to the order of the splats'
atomic adds.

``differentiable=True`` detaches what the JAX package stops: the sampled
directions and their pdfs, the light sample's position, normal and area
pdf, and every MIS weight; gradients flow through BSDF values, emission
and the geometry terms (``grad.render_bdpt_diff``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..camera import Camera, importance_we, primary_ray
from ..materials import (PI, MatParams, bxdf_eval, bxdf_pdf, bxdf_sample,
                         gather_material)
from ..ops.intersect import intersect_core, occluded, shade_hit
from ..ops.lights import light_pdf_of_hit, sample_cosine_dir, sample_light
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..scene.data import UNLIT
from ..utils import cuda_graph, rng
from ..utils.profiling import live_lanes, span, spanned, unit
from ..utils.vec import Vec3, reflect, where as vwhere
from .frame import Frame
from .light import splat_film
from .path import _detacher, _ones3, _zeros3, apply_textures

# rng purpose tags private to BDPT (past the shared ones)
EYE_U0, EYE_U1, EYE_LOT = 16, 17, 18
LGT_U0, LGT_U1, LGT_LOT = 19, 20, 21


def _full(n: int, value, device) -> torch.Tensor:
    """[n] float32 filled with ``value`` (a float or a 0-d tensor)."""
    return torch.zeros((n,), dtype=torch.float32, device=device) + value


def geo(p1: Vec3, n1: Vec3, p2: Vec3, n2: Vec3):
    v = p2 - p1
    d2 = v.norm2()
    vn = v.normalized(1e-20)
    return vn.dot(n1).abs() * (-vn).dot(n2).abs() / torch.clamp(d2, min=1e-20)


def _vertex_pdfs(params: MatParams, wi: Vec3, wo: Vec3, ns: Vec3, ng: Vec3,
                 dir_pdf, eta_scene, types=None):
    """fwd/rev projected-solid-angle pdfs and the delta flag of a walk
    vertex (BDPT.hpp:256-267)."""
    cos_f = wi.dot(ng).abs()
    fwd = dir_pdf / torch.clamp(cos_f, min=1e-20)
    is_delta = params.is_delta
    rev_raw = bxdf_pdf(params, wo, wi, ns, eta_scene, params.eta, types=types)
    rev = rev_raw / torch.clamp(wo.dot(ng).abs(), min=1e-20)
    rev = torch.where(is_delta, fwd, rev)
    return fwd, rev, is_delta


def _walk(scene, o, d, tp0: Vec3, lane, sample_idx, seed, opts,
          n_vertices: int, start_bounce: int, adjoint: bool,
          u_tags) -> List[Dict]:
    """The random walk shared by the eye (BDPT.hpp:226-293) and the light
    subpath (BDPT.hpp:332-389). Returns a list of vertex dicts; a vertex is
    valid only if it was hit AND its continuation sample succeeded with a
    nonzero pdf (the reference breaks before storing it otherwise,
    BDPT.hpp:246-255). Each step makes one nearest-hit call, whether or not
    any lane still walks."""
    n = lane.shape[0]
    eta_scene = scene.eta
    types = scene.mtype_set
    u0t, u1t, lott = u_tags
    sg = _detacher(opts)

    verts: List[Dict] = []
    walking = torch.ones((n,), dtype=torch.bool, device=lane.device)
    tp = tp0
    prev_pos = o
    prev_ng = None
    state_o, state_d = o, d
    for k in range(n_vertices):
        b = start_bounce + k
        u = lambda p: rng.uniform(seed, lane, sample_idx, b, p)
        core = intersect_core(scene, state_o, state_d, mask=walking)
        hit = shade_hit(scene, state_o, state_d, core)
        params = gather_material(scene, hit.mat)
        params, ns = apply_textures(scene, hit, params)
        hit = hit._replace(ns=ns)

        exists = walking & hit.hit
        wo = -state_d

        samp = bxdf_sample(params, wo, hit.ns, u(u0t), u(u1t), u(lott),
                           eta_scene, opts.ggx_sample_bug, types=types)
        wi = sg(samp.wi)
        dir_pdf = sg(bxdf_pdf(params, wi, wo, hit.ns, eta_scene, params.eta,
                              types=types))
        tir = samp.tir
        wi = vwhere(tir, reflect(wo, hit.ns).normalized(1e-20), wi)
        dir_pdf = torch.where(tir, 1.0, dir_pdf)

        stored = exists & samp.success & (dir_pdf != 0.0)
        fwd, rev, is_delta = _vertex_pdfs(params, wi, wo, hit.ns, hit.ng,
                                          dir_pdf, eta_scene, types=types)
        g = geo(prev_pos, prev_ng if prev_ng is not None else hit.ng,
                hit.pos, hit.ng)

        verts.append(dict(
            pos=hit.pos, ng=hit.ng, ns=hit.ns, params=params, tp=tp,
            fwd=fwd, rev=rev, g=g, delta=is_delta, valid=stored,
            wo=wo,  # toward the previous vertex
            hit_kind=hit.kind, hit_idx=hit.idx, hit_mat=hit.mat,
            hit_area=hit.area,
        ))

        f = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_scene,
                      adjoint=adjoint, tir=tir, types=types)
        cos = wi.dot(hit.ng).abs()
        walking = stored & ~params.emissive & (dir_pdf >= MIN_DIVISOR)
        tp = tp * f * (cos / torch.clamp(dir_pdf, min=1e-20))

        inside = hit.ns.dot(wi) < 0.0
        state_o = hit.pos + vwhere(inside, -hit.ns, hit.ns) * EPSILON
        state_d = wi
        prev_pos = hit.pos
        prev_ng = hit.ng
    return verts


@spanned("bdpt.eye")
def build_eye_path(scene, cam: Camera, px, py, lane, sample_idx, seed,
                   opts: RenderOptions):
    """Camera vertex and its walk (the vertex set-up of integrate(),
    BDPT.hpp:713-739, then buildEyePath). Returns (vertices, the pixel's
    point on the image plane)."""
    n = lane.shape[0]
    dev = lane.device
    o, d, pixel_pos = primary_ray(cam, px, py)
    wi_n_cos = d.dot(cam.fwd).abs()
    d2 = (pixel_pos - cam.position).norm2()
    fwd0 = d2 * cam.film_area_inv / torch.clamp(wi_n_cos * wi_n_cos,
                                                min=1e-20)
    cam_vert = dict(
        pos=o, ng=Vec3(*(_full(n, c, dev) for c in cam.fwd)),
        ns=None, params=None, tp=_ones3(n, dev), fwd=fwd0,
        rev=_full(n, cam.lens_area_inv, dev),
        g=_full(n, 1.0, dev),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev), wo=None,
    )
    pdf_cam_w = d2 * cam.lens_area_inv * cam.film_area_inv / \
        torch.clamp(wi_n_cos, min=1e-20)
    t1 = wi_n_cos / torch.clamp(pdf_cam_w, min=1e-20)
    walk = _walk(scene, o, d, Vec3(t1, t1, t1), lane, sample_idx, seed, opts,
                 n_vertices=opts.bdpt_max_path_length, start_bounce=0,
                 adjoint=False, u_tags=(EYE_U0, EYE_U1, EYE_LOT))
    # a vertex is valid only if every ancestor was stored
    prev = cam_vert['valid']
    for v in walk:
        v['valid'] = v['valid'] & prev
        prev = v['valid']
    # vertex 1's G is relative to the camera position
    if walk:
        walk[0]['g'] = geo(cam_vert['pos'], cam_vert['ng'], walk[0]['pos'],
                           walk[0]['ng'])
    return [cam_vert] + walk, pixel_pos


@spanned("bdpt.light")
def build_light_path(scene, cam: Camera, lane, sample_idx, seed,
                     opts: RenderOptions):
    """Light vertex and its adjoint walk (buildLightPath,
    BDPT.hpp:296-390)."""
    n = lane.shape[0]
    dev = lane.device
    sg = _detacher(opts)
    u = lambda p: rng.uniform(seed, lane, sample_idx, 0, p)
    ls = sample_light(scene, u(rng.LIGHT_PICK), u(rng.LIGHT_U),
                      u(rng.LIGHT_V), opts.tutu_light_pick,
                      opts.tutu_tri_sample)
    ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng), pdf_area=sg(ls.pdf_area))
    wi, dir_pdf, dir_ok = sample_cosine_dir(ls.ng, u(rng.LIGHT_DIR_U0),
                                            u(rng.LIGHT_DIR_U1))
    wi = sg(wi)
    dir_pdf = sg(dir_pdf)
    valid0 = ls.valid & dir_ok
    cos0 = wi.dot(ls.ng).abs()
    inv_pick = 1.0 / torch.clamp(ls.pdf_area, min=1e-20)
    lv0 = dict(
        pos=ls.pos, ng=ls.ng, ns=ls.ng, params=None, emission=ls.emission,
        tp=Vec3(inv_pick, inv_pick, inv_pick),
        fwd=dir_pdf / torch.clamp(cos0, min=1e-20),
        rev=ls.pdf_area,           # the pick pdf stash (BDPT.hpp:309)
        g=_full(n, 1.0, dev),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        valid=valid0, wo=None,
    )
    tp1 = lv0['tp'] * (cos0 / torch.clamp(dir_pdf, min=1e-20))
    o = ls.pos + ls.ng * EPSILON
    walk = _walk(scene, o, wi, tp1, lane, sample_idx, seed, opts,
                 n_vertices=opts.bdpt_max_path_length - 1, start_bounce=1,
                 adjoint=True, u_tags=(LGT_U0, LGT_U1, LGT_LOT))
    prev = valid0
    for v in walk:
        v['valid'] = v['valid'] & prev
        prev = v['valid']
    if walk:
        walk[0]['g'] = geo(lv0['pos'], lv0['ng'], walk[0]['pos'],
                           walk[0]['ng'])
        # a light path whose second vertex is an emitter ends before
        # storing it (BDPT.hpp:329-330); later emissive hits are stored
        # and end the walk after them
        walk[0]['valid'] = walk[0]['valid'] & ~walk[0]['params'].emissive
        run = walk[0]['valid']
        for v in walk[1:]:
            v['valid'] = v['valid'] & run
            run = v['valid']
    return [lv0] + walk


def _proj_pdf(params: MatParams, wi: Vec3, wo: Vec3, ns: Vec3, ng: Vec3,
              eta_scene, types=None):
    """pdf(wi, wo, Ns) / |wi.Ng|: the projected-solid-angle pdf at a
    connection end (BDPT.hpp:108-140)."""
    p = bxdf_pdf(params, wi, wo, ns, eta_scene, params.eta, types=types)
    return p / torch.clamp(wi.dot(ng).abs(), min=1e-20)


def mis_end_requests(cam: Camera, ep, lp, s: int, t: int):
    """The connection-end pdfs strategy (s, t) needs (BDPT.hpp:82-142), as
    deferred PAIR requests (params, a, b, ns, ng), each resolved in both
    directions (fwd = pdf(a, b), rev = pdf(b, a)), so that every strategy's
    material dispatch is one stacked ``bxdf_pdf`` call. Returns (requests,
    finish), where ``finish(pdfs)`` takes the resolved projected pdfs as
    [fwd_0, rev_0, fwd_1, rev_1, ...] and returns the end-pdf dict."""
    n = ep[0]['valid'].shape[0]
    dev = ep[0]['valid'].device
    if s + t == 2 or s == 0:
        return [], lambda pdfs: None

    s_end = lp[s - 1]
    t_end = ep[t - 1]
    g_connect = geo(s_end['pos'], s_end['ng'], t_end['pos'], t_end['ng'])
    if t == 1:
        cam2s = (s_end['pos'] - t_end['pos']).normalized(1e-20)
        camcos = t_end['ng'].dot(cam2s)
        dist = cam.image_plane_dist / torch.clamp(camcos, min=1e-20)
        pdf_t_fwd = (cam.film_area_inv * dist * dist /
                     torch.clamp(camcos, min=1e-20)) / \
            torch.clamp(camcos, min=1e-20)
        pdf_t_rev = _full(n, cam.lens_area_inv, dev)
        s2prev = (lp[s - 2]['pos'] - s_end['pos']).normalized(1e-20)
        reqs = [(s_end['params'], -cam2s, s2prev, s_end['ns'], s_end['ng'])]

        def finish(pdfs):
            return dict(pdf_s_fwd=pdfs[0], pdf_s_rev=pdfs[1],
                        pdf_t_fwd=pdf_t_fwd, pdf_t_rev=pdf_t_rev,
                        g_connect=g_connect)
        return reqs, finish
    if s == 1:
        l2t = (t_end['pos'] - s_end['pos']).normalized(1e-20)
        pdf_s_fwd = _full(n, 1.0 / PI, dev)
        pdf_s_rev = s_end['rev']     # the pick pdf stash
        t2prev = (ep[t - 2]['pos'] - t_end['pos']).normalized(1e-20)
        reqs = [(t_end['params'], -l2t, t2prev, t_end['ns'], t_end['ng'])]

        def finish(pdfs):
            return dict(pdf_s_fwd=pdf_s_fwd, pdf_s_rev=pdf_s_rev,
                        pdf_t_fwd=pdfs[0], pdf_t_rev=pdfs[1],
                        g_connect=g_connect)
        return reqs, finish
    s2t = (t_end['pos'] - s_end['pos']).normalized(1e-20)
    s2prev = (lp[s - 2]['pos'] - s_end['pos']).normalized(1e-20)
    t2prev = (ep[t - 2]['pos'] - t_end['pos']).normalized(1e-20)
    reqs = [(s_end['params'], s2t, s2prev, s_end['ns'], s_end['ng']),
            (t_end['params'], -s2t, t2prev, t_end['ns'], t_end['ng'])]

    def finish(pdfs):
        return dict(pdf_s_fwd=pdfs[0], pdf_s_rev=pdfs[1],
                    pdf_t_fwd=pdfs[2], pdf_t_rev=pdfs[3],
                    g_connect=g_connect)
    return reqs, finish


def mis_weight(scene, cam: Camera, ep, lp, s: int, t: int, eta_scene,
               weight_kill: bool = True, end_pdfs=None):
    """Power-heuristic MIS weight of strategy (s, t), BDPT.hpp:70-222,
    unrolled for static s, t. ``weight_kill`` reproduces the reference's
    zeroing of weights below MIN_DIVISOR (BDPT.hpp:218-219, read from this
    module's globals at call time); without it only NaN/inf weights are
    killed and the weights partition unity exactly.

    ``end_pdfs``: the connection-end pdf dict of ``mis_end_requests``'
    finish; None resolves the requests here (s = 0 and s + t = 2 need
    none)."""
    n = ep[0]['valid'].shape[0]
    dev = ep[0]['valid'].device
    if s + t == 2:
        return _full(n, 1.0, dev)

    k = s + t - 1
    # ---- connection-end pdfs
    if s == 0:
        pdf_t_fwd = light_pdf_of_hit_vertex(scene, ep[t - 1])
        pdf_t_rev = _full(n, 1.0 / PI, dev)
        pdf_s_fwd = pdf_s_rev = g_connect = None
    else:
        if end_pdfs is None:
            reqs, fin = mis_end_requests(cam, ep, lp, s, t)
            flat = []
            for (p, a, b, ns, ng) in reqs:
                flat.append(_proj_pdf(p, a, b, ns, ng, eta_scene,
                                      types=scene.mtype_set))
                flat.append(_proj_pdf(p, b, a, ns, ng, eta_scene,
                                      types=scene.mtype_set))
            end_pdfs = fin(flat)
        pdf_s_fwd = end_pdfs['pdf_s_fwd']
        pdf_s_rev = end_pdfs['pdf_s_rev']
        pdf_t_fwd = end_pdfs['pdf_t_fwd']
        pdf_t_rev = end_pdfs['pdf_t_rev']
        g_connect = end_pdfs['g_connect']

    # ---- MIS nodes (BDPT.hpp:147-185)
    toward_light = [None] * (s + t)
    toward_eye = [None] * (s + t)
    is_delta = [None] * (s + t)
    for i in range(0, s - 1):
        toward_light[i] = lp[0]['rev'] if i == 0 else lp[i]['rev'] * lp[i]['g']
        toward_eye[i] = lp[i]['fwd'] * lp[i + 1]['g']
        is_delta[i] = lp[i]['delta']
    if s > 0:
        toward_light[s - 1] = pdf_s_rev if s == 1 else \
            pdf_s_rev * lp[s - 1]['g']
        toward_eye[s - 1] = pdf_s_fwd * g_connect
        is_delta[s - 1] = lp[s - 1]['delta']
    for ti in range(0, t - 1):
        toward_eye[k - ti] = ep[ti]['rev'] if ti == 0 else \
            ep[ti]['rev'] * ep[ti]['g']
        toward_light[k - ti] = ep[ti]['fwd'] * ep[ti + 1]['g']
        is_delta[k - ti] = ep[ti]['delta']
    toward_eye[k - (t - 1)] = pdf_t_rev if t == 1 else \
        pdf_t_rev * ep[t - 1]['g']
    toward_light[k - (t - 1)] = pdf_t_fwd if s == 0 else \
        pdf_t_fwd * g_connect
    is_delta[k - (t - 1)] = ep[t - 1]['delta']

    def div(a, b):
        return a / torch.where(b.abs() < 1e-30, 1e-30, b)

    denom = _full(n, 1.0, dev)
    p = _full(n, 1.0, dev)
    for i in range(s, k):
        if i == 0:
            p = p * div(toward_light[0], toward_light[1])
            skip = is_delta[1]
        else:
            p = p * div(toward_eye[i - 1], toward_light[i + 1])
            skip = is_delta[i] | is_delta[i + 1]
        denom = denom + torch.where(skip, 0.0, p * p)
    p = _full(n, 1.0, dev)
    for i in range(s, 0, -1):
        if i == 1:
            p = p * div(toward_light[1], toward_light[0])
            skip = is_delta[0]
        else:
            p = p * div(toward_light[i], toward_eye[i - 2])
            skip = is_delta[i - 1] | is_delta[i - 2]
        denom = denom + torch.where(skip, 0.0, p * p)

    w = 1.0 / denom
    bad = torch.isnan(w) | torch.isinf(w)
    if weight_kill:
        bad = bad | (w < MIN_DIVISOR)
    return torch.where(bad, 0.0, w)


def light_pdf_of_hit_vertex(scene, v):
    """getLightPdf of a stored vertex: the per-vertex light pick pdf that
    ``render_sample_bdpt``'s s=0 strategy stashes. A missing stash raises
    ``KeyError`` rather than computing the MIS chain from a pick pdf of 0."""
    return v['light_pick_pdf']


def light_pdf_of_hit_params(scene, v):
    """1 / (n_lights * area) of a stored emissive eye vertex, from the hit
    kind, primitive and material captured when the vertex was built."""
    return light_pdf_of_hit(scene, v['hit_kind'], v['hit_idx'], v['hit_mat'],
                            v.get('hit_area'))


def _cat_params(params: List[MatParams]) -> MatParams:
    """The per-lane material fields of several requests, one after the
    other."""
    cat = lambda xs: torch.cat(xs)
    return MatParams(*(
        Vec3(*(cat([getattr(f, c) for f in fields]) for c in "xyz"))
        if isinstance(fields[0], Vec3) else cat(list(fields))
        for fields in zip(*params)))


def _stack(tuples):
    """Stack queued requests (params, four Vec3) into one wavefront."""
    vec = lambda j: Vec3(*(torch.cat([getattr(r[j], c) for r in tuples])
                           for c in "xyz"))
    return _cat_params([r[0] for r in tuples]), vec(1), vec(2), vec(3), \
        vec(4)


def render_sample_bdpt(scene, cam: Camera, px, py, lane, sample_idx, seed,
                       opts: RenderOptions):
    """One BDPT sample per lane. Returns (estimate Vec3 [N], splat_idx
    list, splat_rgb list): the estimate goes to the lane's own pixel, each
    t=1 splat to its index (-1 for none)."""
    ep, pixel_pos = build_eye_path(scene, cam, px, py, lane, sample_idx,
                                   seed, opts)
    lp = build_light_path(scene, cam, lane, sample_idx, seed, opts)
    we_pix, _ = importance_we(cam, pixel_pos)
    with span("bdpt.connect") as sp:
        return _connect(scene, cam, ep, lp, we_pix, opts, sp)


def _connect(scene, cam: Camera, ep, lp, we_pix, opts: RenderOptions, sp):
    """Every strategy of one wavefront from its two subpaths -> what
    ``render_sample_bdpt`` returns; ``sp`` is the ``bdpt.connect`` span,
    which counts the shadow rays."""
    n = we_pix.shape[0]
    dev = we_pix.device
    eta_scene = scene.eta
    types = scene.mtype_set
    # MIS weights are pdf ratios: piecewise-constant like every other
    # sampling decision
    sg = _detacher(opts)

    estimate = _zeros3(n, dev)
    z3 = _zeros3(n, dev)
    splat_idx = []
    splat_rgb = []

    # deferred occlusion: every connection strategy's shadow ray is queued
    # and all are traced in one any-hit call after the strategy loop
    occl_o: List[Vec3] = []
    occl_d: List[Vec3] = []
    occl_dist: List = []
    occl_mask: List = []
    pending: List[Dict] = []

    def queue_occlusion(orig: Vec3, dirn: Vec3, dist, live) -> int:
        occl_o.append(orig)
        occl_d.append(dirn)
        occl_dist.append(dist)
        occl_mask.append(live)
        return len(occl_o) - 1

    max_len = opts.bdpt_max_path_length
    l_emission = lp[0]['emission']

    def strategy_weight(w):
        # CHECK_MIS: a strategy's unweighted contribution
        return _full(n, 1.0, dev) if opts.bdpt_unweighted else w

    # an UNLIT first hit: its diffuse once, counted under (s=0, t=2) so
    # that the strategy filters partition it too
    if opts.bdpt_s_filter in (-1, 0) and opts.bdpt_t_filter in (-1, 2):
        v1 = ep[1]
        unlit = v1['valid'] & (v1['params'].mtype == UNLIT)
        estimate = estimate + vwhere(unlit, v1['params'].diffuse, z3)

    # ---- phase A: enumerate the strategies, queueing every material
    # dispatch (bxdf_eval, connection-end bxdf_pdf) for the three stacked
    # calls of phase B; s=0 strategies have none and finish here
    pdf_reqs: List = []        # (params, a, b, ns, ng) pairs
    eval_reqs: List = []       # (params, wi, wo, ng, ns), adjoint=False
    aeval_reqs: List = []      # the same, adjoint=True
    records: List[Dict] = []

    def q_pdf(reqs):
        i0 = len(pdf_reqs)
        pdf_reqs.extend(reqs)
        return i0

    def q_eval(queue, params, wi, wo, ng, ns):
        queue.append((params, wi, wo, ng, ns))
        return len(queue) - 1

    for path_length in range(1, max_len + 1):
        for s in range(0, path_length + 1):
            t = path_length + 1 - s
            if t < 1 or t > len(ep) or s > len(lp):
                continue
            # S_CHECK / T_CHECK strategy isolation (BDPT.hpp:490-493)
            if opts.bdpt_s_filter >= 0 and s != opts.bdpt_s_filter:
                continue
            if opts.bdpt_t_filter >= 0 and t != opts.bdpt_t_filter:
                continue

            if s == 0:
                ev = ep[t - 1]
                if ev['params'] is None:
                    continue
                ok = ev['valid'] & ev['params'].emissive
                contrib = ev['tp'] * ev['params'].emission * we_pix
                zero_c = (contrib.x == 0) & (contrib.y == 0) & \
                    (contrib.z == 0)
                ok = ok & ~zero_c
                # the vertex's light pick pdf, for the s=0 MIS chain
                ev = dict(ev)
                ev['light_pick_pdf'] = light_pdf_of_hit_params(scene, ev)
                ep_mod = list(ep)
                ep_mod[t - 1] = ev
                w = strategy_weight(sg(mis_weight(
                    scene, cam, ep_mod, lp, s, t, eta_scene,
                    opts.tutu_bdpt_weight_kill)))
                estimate = estimate + vwhere(ok, contrib * w, z3)
                continue

            if t == 1:
                # lp[0] is the emitter itself, which the reference skips
                # (BDPT.hpp:790): (s=1, t=1) never contributes
                if s == 1:
                    continue
                lv = lp[s - 1]
                ok = lv['valid'] & ~lv['params'].emissive
                if opts.tutu_bdpt_t1_gate:
                    # the reference leaves the SPP loop when the camera
                    # ray misses (BDPT.hpp:733-734), dropping the lane's
                    # light path and its splats
                    ok = ok & ep[1]['valid']
                orig = lv['pos']
                wi = (cam.position - orig).normalized(1e-20)
                wo = (lp[s - 2]['pos'] - lv['pos']).normalized(1e-20)
                inside = wi.dot(lv['ns']) < 0.0
                bsdf_q = q_eval(aeval_reqs, lv['params'], wi, wo,
                                lv['ng'], lv['ns'])
                g = geo(cam.position, cam.fwd, lv['pos'], lv['ng'])
                we_v, idx = importance_we(cam, lv['pos'])
                oo = lv['pos'] + vwhere(inside, -lv['ns'], lv['ns']) * EPSILON
                toc = cam.position - oo
                dc = toc.norm()
                front = wi.dot(cam.fwd) < 0.0
                ok = ok & front & (idx >= 0)
                q = queue_occlusion(oo, toc * (1.0 / torch.clamp(dc,
                                                                 min=1e-20)),
                                    dc, ok)
                reqs, fin = mis_end_requests(cam, ep, lp, s, t)
                records.append(dict(
                    kind='splat', s=s, t=t, ok=ok, q=q, idx=idx,
                    prefac=l_emission * lv['tp'] * (g * we_v / opts.spp),
                    bsdf_q=bsdf_q, pdf_i0=q_pdf(reqs), fin=fin))
                continue

            # the general connection (BDPT.hpp:836-885)
            lv = lp[s - 1]
            ev = ep[t - 1]
            if ev['params'] is None:
                continue
            ok = lv['valid'] & ev['valid'] & ~ev['params'].emissive
            connect = (ev['pos'] - lv['pos']).normalized(1e-20)
            e_wo = (ep[t - 2]['pos'] - ev['pos']).normalized(1e-20)
            ev_q = q_eval(eval_reqs, ev['params'], -connect, e_wo,
                          ev['ng'], ev['ns'])
            if s == 1:
                facing = connect.dot(lv['ns']) >= 0.0
                lv_q = None
                l_orig = lv['pos'] + lv['ns'] * EPSILON
            else:
                facing = None
                l_wo = (lp[s - 2]['pos'] - lv['pos']).normalized(1e-20)
                lv_q = q_eval(aeval_reqs, lv['params'], connect, l_wo,
                              lv['ng'], lv['ns'])
                l_inside = l_wo.dot(lv['ns']) < 0.0
                l_orig = lv['pos'] + vwhere(l_inside, -lv['ns'],
                                            lv['ns']) * EPSILON
            e_inside = e_wo.dot(ev['ns']) < 0.0
            e_orig = ev['pos'] + vwhere(e_inside, -ev['ns'], ev['ns']) * \
                EPSILON
            g = geo(ev['pos'], ev['ng'], lv['pos'], lv['ng'])
            seg = l_orig - e_orig
            seg_len = seg.norm()
            q = queue_occlusion(e_orig,
                                seg * (1.0 / torch.clamp(seg_len, min=1e-20)),
                                seg_len, ok)
            reqs, fin = mis_end_requests(cam, ep, lp, s, t)
            records.append(dict(
                kind='est', s=s, t=t, ok=ok, q=q,
                prefac=ev['tp'] * lv['tp'] * l_emission * (g * we_pix),
                ev_q=ev_q, lv_q=lv_q, facing=facing,
                pdf_i0=q_pdf(reqs), fin=fin))

    # ---- phase B: one stacked dispatch per queue. Each pdf row is
    # evaluated in both directions (fwd = pdf(a, b), rev = pdf(b, a))
    proj_fwd: List = []
    proj_rev: List = []
    if pdf_reqs:
        params_b, a_b, b_b, ns_b, ng_b = _stack(pdf_reqs)
        p_fwd = bxdf_pdf(params_b, a_b, b_b, ns_b, eta_scene, params_b.eta,
                         types=types)
        p_fwd = p_fwd / torch.clamp(a_b.dot(ng_b).abs(), min=1e-20)
        p_rev = bxdf_pdf(params_b, b_b, a_b, ns_b, eta_scene, params_b.eta,
                         types=types)
        p_rev = p_rev / torch.clamp(b_b.dot(ng_b).abs(), min=1e-20)
        proj_fwd = list(p_fwd.split(n))
        proj_rev = list(p_rev.split(n))

    def _resolve_evals(reqs, adjoint):
        if not reqs:
            return []
        params_b, wi_b, wo_b, ng_b, ns_b = _stack(reqs)
        f = bxdf_eval(params_b, wi_b, wo_b, ng_b, ns_b, eta_scene,
                      adjoint=adjoint, types=types)
        return [Vec3(*cs) for cs in zip(*(c.split(n) for c in f))]

    evals = _resolve_evals(eval_reqs, False)
    aevals = _resolve_evals(aeval_reqs, True)

    # ---- phase C: finish each strategy with its resolved values; cull on
    # the full weighted contribution (a zeroed MIS weight or BSDF value
    # needs no visibility test: the shadow mask shrinks, the estimate does
    # not change)
    for rec in records:
        s, t = rec['s'], rec['t']
        n_pairs = 1 if (t == 1 or s == 1) else 2
        flat = []
        for i in range(rec['pdf_i0'], rec['pdf_i0'] + n_pairs):
            flat.append(proj_fwd[i])
            flat.append(proj_rev[i])
        end = rec['fin'](flat)
        w = strategy_weight(sg(mis_weight(scene, cam, ep, lp, s, t,
                                          eta_scene,
                                          opts.tutu_bdpt_weight_kill,
                                          end_pdfs=end)))
        if rec['kind'] == 'splat':
            rgb = rec['prefac'] * aevals[rec['bsdf_q']] * w
        else:
            lv_bsdf = _ones3(n, dev) if rec['lv_q'] is None \
                else aevals[rec['lv_q']]
            if rec['facing'] is not None:
                lv_bsdf = vwhere(rec['facing'], lv_bsdf, z3)
            rgb = rec['prefac'] * evals[rec['ev_q']] * lv_bsdf * w
        ok = rec['ok'] & ~((rgb.x == 0) & (rgb.y == 0) & (rgb.z == 0))
        occl_mask[rec['q']] = ok
        pending.append(dict(kind=rec['kind'], ok=ok, q=rec['q'],
                            idx=rec.get('idx'), rgb=rgb))

    # ---- one any-hit call over every queued connection shadow ray
    if occl_o:
        cat = lambda vs: Vec3(*(torch.cat([getattr(v, c) for v in vs])
                                for c in "xyz"))
        live = torch.cat(occl_mask)
        if sp.on:
            sp.count("rays", live.shape[0])
            sp.count("live", live_lanes(live))
        blocked_all = occluded(scene, cat(occl_o), cat(occl_d),
                               torch.cat(occl_dist), mask=live)
        blocked_rows = blocked_all.reshape(len(occl_o), n)
        for rec in pending:
            ok = rec['ok'] & ~blocked_rows[rec['q']]
            if rec['kind'] == 'est':
                estimate = estimate + vwhere(ok, rec['rgb'], z3)
            else:
                splat_idx.append(torch.where(ok, rec['idx'], -1))
                splat_rgb.append(rec['rgb'])

    bad = torch.isnan(estimate.x) | torch.isnan(estimate.y) | \
        torch.isnan(estimate.z)
    estimate = vwhere(bad, z3, estimate)
    return estimate, splat_idx, splat_rgb


class BDPTFrame(Frame):
    """BDPT's schedule, over the whole film: lanes in plain pixel order;
    one accumulator, the film [p + 1, 3] (slot ``p`` takes the off-film
    splats), starting at the background colour under every pixel
    (Camera.hpp:28, BDPT.hpp:891-897); a step adds a wavefront's estimates
    times 1/spp and its splats, which carry it already; the image is the
    film with NaN pixels set to 0."""

    name = "bdpt"

    def accumulators(self):
        p = self.cam.n_pixels
        film = torch.zeros((p + 1, 3), dtype=torch.float32,
                           device=self.scene.device)
        film[:p] = torch.stack(tuple(self.scene.bkgcolor)).to(torch.float32)
        return (film,)

    def step(self, scene, outs, lanes, first):
        film, = outs
        p = self.cam.n_pixels
        est, sidx, srgb = render_sample_bdpt(
            scene, self.cam, lanes.px, lanes.py, lanes.pix,
            first + lanes.soff, self.seed, self.opts)
        film[:p] += torch.stack([c.reshape(self.sb, p).sum(dim=0)
                                 for c in est], -1) * (1.0 / self.opts.spp)
        with span("bdpt.splat") as sp:
            if sp.on and sidx:
                sp.count("splats", live_lanes(torch.cat(sidx) >= 0))
            return (splat_film(film, sidx, srgb),)

    def image(self, outs, lanes):
        img = outs[0][:self.cam.n_pixels]
        img = torch.where(torch.isnan(img), 0.0, img)
        return img.reshape(self.cam.height, self.cam.width, 3)


def render(scene, cam: Camera, opts: RenderOptions, seed=0, sample_base=0):
    """Full-frame render -> [H, W, 3] linear radiance on the scene's device.
    ``sample_base`` shifts the global sample indices so chunked renders
    continue the exact stream.

    ``opts.samples_per_launch`` > 1 batches that many spp into one
    wavefront (``BDPTFrame``): the RNG is keyed by (pixel, sample), so the
    image is that of the one-sample schedule up to float order."""
    with unit("render"):
        frame = BDPTFrame(scene, cam, opts, seed, sample_base)
        outs, lanes = cuda_graph.run(
            frame, cuda_graph.eligible(scene.device, opts, seed, sample_base))
        return frame.image(outs, lanes)
