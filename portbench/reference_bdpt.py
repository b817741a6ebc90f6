"""The plain BDPT reference: bidirectional path tracing in plain PyTorch.

It computes, lane by lane, what the program's ``integrators/bdpt.py``
``render`` computes (BDPT.hpp:59-900 as the JAX package and the port read
it), from the scene arrays, the configuration's camera and the frozen
random numbers of ``ref_rng``, and shares no code with the program. It uses
``reference.py``'s materials, scene, tree and vector helpers. Per lane (one
pixel and one sample id):

- an eye subpath of ``bdpt_max_path_length`` vertices after the camera and
  a light subpath of one fewer after a point drawn on a light, each vertex
  drawn from its material with BDPT's private purposes 16-18 (eye) and
  19-21 (light), the light point and its cosine-weighted direction with the
  shared purposes 0-2 and 9-10 at bounce 0; a vertex counts only if it was
  hit and its own continuation was drawn with a nonzero pdf, and every
  vertex before it counted; the light subpath ends before a first bounce
  that lands on an emitter;
- every strategy (s, t) up to the path length, s light vertices joined to
  t eye vertices: s = 0 an eye vertex on an emitter, t = 1 a light vertex
  seen by the camera and splatted through the camera's importance onto the
  pixel it projects to (off the film: dropped), otherwise a connection
  through the two ends' BSDFs and the geometry term, with one shadow ray;
- each strategy weighted by the power heuristic over the projected
  solid-angle pdfs of the path's vertices, both ways, a delta vertex left
  out of the chain; a weight that is not finite or below ``MIN_DIVISOR``
  counts 0 (``tutu_bdpt_weight_kill``);
- (s = 1) a connection only where it leaves the light's front side; no
  splat from a lane whose camera ray found nothing
  (``tutu_bdpt_t1_gate``);
- the lane's estimate 0 where it is not a number; the film starts at the
  background colour, takes each estimate over the samples a pixel and each
  splat over the same count, and a pixel that is not a number reads 0.

How it differs from the program, in structure only:

- a vertex is a dict of [N] and [N, 3] tensors of one dtype, so the same
  code runs in float32 (the configuration's precision) and in bfloat16 (the
  control); rays are traced for the lanes that still walk, gathered by
  index, where the program masks full-width columns;
- rays meet triangles through ``reference.py``'s Moller-Trumbore tests and
  its own tree, where the program walks its cluster tables with its
  kernels;
- the shadow rays of a block of lanes, those of the valid connections only,
  go to one any-hit walk; the lanes go in blocks, so a whole 512 x 512 film
  fits on one card.

Departures from BDPT.hpp, all of them the program's too: projected
solid-angle vertex pdfs; the light pick pdf kept as the light vertex's
reverse pdf (BDPT.hpp:309); a light path's first emissive bounce not
stored (BDPT.hpp:329-330); an UNLIT first hit counted once, under
(s = 0, t = 2); splats added to a film of ``p + 1`` slots where the
reference adds them under a lock. It supports the materials of
``reference.py`` and the program's defaults of the quirk flags
(``MODELLED``), and refuses a configuration that sets them otherwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import ref_rng as rng
from .reference import (EPSILON, GLASS, MIN_DIVISOR, MIRROR, PI, UNLIT,
                        RefScene, bsdf_eval, bsdf_pdf, bsdf_sample, dot,
                        normalize, reflect, sel, to_world)

# draw purposes: the light's direction, then BDPT's own
LIGHT_DIR_U0, LIGHT_DIR_U1 = 9, 10
EYE_TAGS = (16, 17, 18)
LIGHT_TAGS = (19, 20, 21)
MODELLED = dict(tutu_bdpt_weight_kill=True, tutu_bdpt_t1_gate=True,
                tutu_light_pick=False, tutu_tri_sample=False,
                ggx_sample_bug=False)
BLOCK = 1 << 20               # lanes a block


class RefCamera:
    """The pinhole camera of the configuration: the image plane at the
    distance where a pixel has unit area, its grid stepping
    (ur - ul) / (width - 1), and the world-to-raster chain of the
    reference (world to camera, a perspective with near 0.1 and far 1e4,
    then to pixels), built in float64 and used in the scene's dtype."""

    def __init__(self, cam_cfg: dict, width: int, height: int, dtype,
                 device):
        eye = np.asarray(cam_cfg["eye"], np.float64)
        fwd = np.asarray(cam_cfg["viewdir"], np.float64)
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(cam_cfg["updir"], np.float64))
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        up = up / np.linalg.norm(up)
        hfov = float(cam_cfg["hfov"])
        tan_half = math.tan(math.radians(hfov * 0.5))
        dist = width / (2.0 * tan_half)
        half_w = abs(tan_half * dist)
        half_h = half_w / (width / height)
        centre = eye + dist * fwd
        ul = centre - half_w * right + half_h * up
        ur = centre + half_w * right + half_h * up
        ll = centre - half_w * right - half_h * up
        # world -> camera -> clip -> raster, row-major
        w2c = np.eye(4)
        w2c[0, :3], w2c[1, :3], w2c[2, :3] = right, up, -fwd
        w2c[:3, 3] = -np.array([right @ eye, up @ eye, -fwd @ eye])
        near, far = 0.1, 10000.0
        r = math.tan(math.radians(hfov / 2.0)) * near
        t = r / (width / height)
        persp = np.zeros((4, 4))
        persp[0, 0] = persp[1, 1] = near
        persp[2, 2], persp[2, 3], persp[3, 2] = near + far, near * far, -1.0
        ortho = np.diag([1.0 / r, -1.0 / t, 2.0 / (near - far), 1.0]) @ \
            np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, 1, -(near + far) / 2.0], [0, 0, 0, 1.0]])
        to_px = np.diag([width * 0.5, height * 0.5, 0.0, 1.0]) @ \
            np.array([[1, 0, 0, 1.0], [0, 1, 0, 1.0], [0, 0, 1, 0],
                      [0, 0, 0, 1]])
        self.w2r = (to_px @ ortho @ persp @ w2c).astype(np.float32)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device).to(dtype)
        self.eye, self.fwd = f(eye), f(fwd)
        self.ul, self.off = f(ul), f((ur - ul) / (2.0 * width) +
                                     (ll - ul) / (2.0 * height))
        self.dh, self.dv = f((ur - ul) / (width - 1)), f((ll - ul) /
                                                         (height - 1))
        self.m = f(self.w2r)
        self.plane_dist = float(np.float32(dist))
        self.film_inv = float(np.float32(1.0 / (width * height)))
        self.lens_inv = 1.0
        self.width, self.height = width, height

    def pixel_points(self, pixel):
        """The centres of pixels ``pixel`` (row-major ids) on the image
        plane -> [N, 3]."""
        dt = self.ul.dtype
        px = (pixel % self.width).to(dt)[:, None]
        py = (pixel // self.width).to(dt)[:, None]
        return self.ul[None] + self.dh[None] * px + self.dv[None] * py + \
            self.off[None]

    def pixel_of(self, pos):
        """The pixel a world point projects to (the raster coordinate less
        a half, truncated toward zero), -1 off the film or not finite."""
        m = self.m
        row = lambda i: m[i, 0] * pos[:, 0] + m[i, 1] * pos[:, 1] + \
            m[i, 2] * pos[:, 2] + m[i, 3]
        inv_w = 1.0 / row(3)
        rx, ry = row(0) * inv_w - 0.5, row(1) * inv_w - 0.5
        finite = torch.isfinite(rx) & torch.isfinite(ry)
        ix = torch.where(finite, rx, -1.0).to(torch.int32)
        iy = torch.where(finite, ry, -1.0).to(torch.int32)
        inside = finite & (ix >= 0) & (ix < self.width) & (iy >= 0) & \
            (iy < self.height)
        return torch.where(inside, ix + self.width * iy, -1).long()

    def importance(self, pos):
        """The camera's importance We at world points, 0 off the film, and
        their pixels: d^2 / (lens area * film area * cos^2), d the distance
        to the image plane along the ray."""
        idx = self.pixel_of(pos)
        to_cam = normalize(self.eye[None] - pos, 1e-20)
        c = dot(self.fwd[None].expand_as(to_cam), -to_cam).abs()
        d = self.plane_dist / torch.clamp(c, min=1e-20)
        we = d * d * self.lens_inv * self.film_inv / \
            torch.clamp(c * c, min=1e-20)
        return torch.where(idx >= 0, we, 0.0), idx


def geo(p1, n1, p2, n2):
    """The geometry term |cos1| |cos2| / r^2 between two points."""
    v = p2 - p1
    d2 = dot(v, v)
    vn = normalize(v, 1e-20)
    return dot(vn, n1).abs() * dot(-vn, n2).abs() / torch.clamp(d2,
                                                                min=1e-20)


def _full(n, value, like):
    return torch.zeros(n, dtype=like.dtype, device=like.device) + value


# ---------------------------------------------------------------- subpaths

def _hit_vertices(scene: RefScene, o, d, walking):
    """Nearest hits of the walking lanes -> (hit, pos, ng, ns, mat, area),
    full width, zero where a lane does not walk or finds nothing."""
    n, dev = o.shape[0], o.device
    idx = torch.nonzero(walking)[:, 0]
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    pos, ng, ns = (torch.zeros_like(o) for _ in range(3))
    mat = torch.zeros(n, dtype=torch.long, device=dev)
    area = torch.zeros_like(o[:, 0])
    if len(idx):
        h = scene.nearest(o[idx], d[idx])
        p_, g_, s_, m_, a_ = scene.shade(o[idx], d[idx], h)
        hit[idx] = h["hit"]
        pos[idx], ng[idx], ns[idx], mat[idx], area[idx] = p_, g_, s_, m_, a_
    return hit, pos, ng, ns, mat, area


def _walk(scene: RefScene, o, d, tp, lane, smp, seed: int, count: int,
          first_bounce: int, adjoint: bool, tags):
    """``count`` vertices of a random walk from rays o, d with throughput
    ``tp`` -> list of vertex dicts; ``valid`` here is the vertex's own
    (hit, and its continuation drawn with a nonzero pdf)."""
    dt = o.dtype
    eta = scene.eta
    walking = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    prev_pos, prev_ng = o, None
    verts = []
    for k in range(count):
        b = first_bounce + k
        u = lambda purpose: rng.uniform(seed, lane, smp, b, purpose).to(dt)
        hit, pos, ng, ns, mat, area = _hit_vertices(scene, o, d, walking)
        m = scene.material(mat)
        wo = -d
        wi, success, tir = bsdf_sample(m, wo, ns, u(tags[0]), u(tags[1]),
                                       u(tags[2]), eta)
        pdf = bsdf_pdf(m, wi, wo, ns, eta)
        wi = sel(tir, normalize(reflect(wo, ns), 1e-20), wi)
        pdf = torch.where(tir, 1.0, pdf)
        delta = (m["mtype"] == MIRROR) | (m["mtype"] == GLASS)
        fwd = pdf / torch.clamp(dot(wi, ng).abs(), min=1e-20)
        rev = bsdf_pdf(m, wo, wi, ns, eta) / torch.clamp(dot(wo, ng).abs(),
                                                         min=1e-20)
        emissive = scene.emissive(mat)
        verts.append(dict(
            pos=pos, ng=ng, ns=ns, m=m, mat=mat, area=area, tp=tp,
            emissive=emissive, fwd=fwd, rev=torch.where(delta, fwd, rev),
            delta=delta, valid=walking & hit & success & (pdf != 0.0),
            g=geo(prev_pos, ng if prev_ng is None else prev_ng, pos, ng)))
        f = bsdf_eval(m, wo, wi, ng, ns, eta, tir=tir) if adjoint else \
            bsdf_eval(m, wi, wo, ng, ns, eta, tir=tir)
        walking = verts[-1]["valid"] & ~emissive & (pdf >= MIN_DIVISOR)
        tp = tp * f * (dot(wi, ng).abs() / torch.clamp(pdf, min=1e-20)
                       )[:, None]
        o = pos + sel(dot(ns, wi) < 0.0, -ns, ns) * EPSILON
        d = wi
        prev_pos, prev_ng = pos, ng
    return verts


def eye_path(scene, cam: RefCamera, pixel, lane, smp, seed, length):
    """The camera vertex and ``length`` vertices after it -> (vertices,
    the pixel's point on the image plane)."""
    n = pixel.shape[0]
    pp = cam.pixel_points(pixel)
    o = cam.eye[None].expand_as(pp)
    d = normalize(pp - o)
    c = dot(d, cam.fwd[None].expand_as(d)).abs()
    d2 = dot(pp - o, pp - o)
    one = _full(n, 1.0, c)
    cam_v = dict(pos=o, ng=cam.fwd[None].expand_as(o), tp=torch.ones_like(o),
                 fwd=d2 * cam.film_inv / torch.clamp(c * c, min=1e-20),
                 rev=one * cam.lens_inv, g=one,
                 delta=torch.zeros(n, dtype=torch.bool, device=o.device),
                 valid=torch.ones(n, dtype=torch.bool, device=o.device))
    pdf_w = d2 * cam.lens_inv * cam.film_inv / torch.clamp(c, min=1e-20)
    tp = (c / torch.clamp(pdf_w, min=1e-20))[:, None].expand(n, 3)
    walk = _walk(scene, o, d, tp, lane, smp, seed, length, 0, False,
                 EYE_TAGS)
    prev = cam_v["valid"]
    for v in walk:
        v["valid"] = v["valid"] & prev
        prev = v["valid"]
    walk[0]["g"] = geo(o, cam_v["ng"], walk[0]["pos"], walk[0]["ng"])
    return [cam_v] + walk, pp


def light_path(scene, lane, smp, seed, length):
    """A point drawn on a light and ``length - 1`` vertices after it."""
    dt = scene.dtype
    u = lambda purpose: rng.uniform(seed, lane, smp, 0, purpose).to(dt)
    pos, ng, em, pdf_area = scene.sample_light(u(rng.LIGHT_PICK),
                                               u(rng.LIGHT_U),
                                               u(rng.LIGHT_V))
    r0, r1 = u(LIGHT_DIR_U0), u(LIGHT_DIR_U1)
    sin_t = torch.sqrt(torch.clamp(1.0 - r0, min=0.0))
    phi = 2.0 * PI * r1
    wi = to_world(ng, torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                  torch.sqrt(r0))
    dir_pdf = torch.clamp(dot(wi, ng), min=0.0) / PI
    cos0 = dot(wi, ng).abs()
    inv_pick = 1.0 / torch.clamp(pdf_area, min=1e-20)
    n = lane.shape[0]
    lv0 = dict(pos=pos, ng=ng, ns=ng, emission=em,
               tp=inv_pick[:, None].expand(n, 3),
               fwd=dir_pdf / torch.clamp(cos0, min=1e-20), rev=pdf_area,
               g=_full(n, 1.0, cos0),
               delta=torch.zeros(n, dtype=torch.bool, device=pos.device),
               valid=dot(wi, ng) >= 0.0)
    tp = lv0["tp"] * (cos0 / torch.clamp(dir_pdf, min=1e-20))[:, None]
    walk = _walk(scene, pos + ng * EPSILON, wi, tp, lane, smp, seed,
                 length - 1, 1, True, LIGHT_TAGS)
    walk[0]["g"] = geo(pos, ng, walk[0]["pos"], walk[0]["ng"])
    prev = lv0["valid"] & ~walk[0]["emissive"]
    for v in walk:
        v["valid"] = v["valid"] & prev
        prev = v["valid"]
    return [lv0] + walk


# --------------------------------------------------------------- strategies

def _proj_pdf(v, a, b, eta):
    """pdf(a | b) at vertex v over |a . Ng|: projected solid angle."""
    return bsdf_pdf(v["m"], a, b, v["ns"], eta) / \
        torch.clamp(dot(a, v["ng"]).abs(), min=1e-20)


def end_pdfs(scene, cam: RefCamera, ep, lp, s: int, t: int):
    """The pdfs at the two ends of the connection of strategy (s, t), s and
    t both at least 1: each end's pdf toward the other end (fwd) and toward
    its own previous vertex (rev), and the connection's geometry term."""
    eta = scene.eta
    se, te = lp[s - 1], ep[t - 1]
    out = dict(g=geo(se["pos"], se["ng"], te["pos"], te["ng"]))
    if t == 1:
        cam2s = normalize(se["pos"] - te["pos"], 1e-20)
        c = dot(te["ng"], cam2s)
        d = cam.plane_dist / torch.clamp(c, min=1e-20)
        out["t_fwd"] = cam.film_inv * d * d / torch.clamp(c, min=1e-20) / \
            torch.clamp(c, min=1e-20)
        out["t_rev"] = _full(c.shape[0], cam.lens_inv, c)
        back = normalize(lp[s - 2]["pos"] - se["pos"], 1e-20)
        out["s_fwd"] = _proj_pdf(se, -cam2s, back, eta)
        out["s_rev"] = _proj_pdf(se, back, -cam2s, eta)
        return out
    s2t = normalize(te["pos"] - se["pos"], 1e-20)
    t_back = normalize(ep[t - 2]["pos"] - te["pos"], 1e-20)
    out["t_fwd"] = _proj_pdf(te, -s2t, t_back, eta)
    out["t_rev"] = _proj_pdf(te, t_back, -s2t, eta)
    if s == 1:
        out["s_fwd"] = _full(s2t.shape[0], 1.0 / PI, s2t)
        out["s_rev"] = se["rev"]
    else:
        s_back = normalize(lp[s - 2]["pos"] - se["pos"], 1e-20)
        out["s_fwd"] = _proj_pdf(se, s2t, s_back, eta)
        out["s_rev"] = _proj_pdf(se, s_back, s2t, eta)
    return out


def mis_weight(ep, lp, s: int, t: int, end: dict):
    """The power-heuristic weight of strategy (s, t) over every other
    strategy of the same path: node i of the path (light end first) has a
    pdf toward the light and one toward the eye; the other strategies'
    pdfs follow from the ratios along the chain, a delta vertex left out.
    ``end`` holds the connection's end pdfs (s = 0: ``t_fwd`` the light
    pick pdf of the emitter hit, ``t_rev`` 1 / pi)."""
    if s + t == 2:
        return _full(ep[0]["valid"].shape[0], 1.0, ep[0]["fwd"])
    k = s + t - 1
    to_light, to_eye, delta = [None] * (k + 1), [None] * (k + 1), \
        [None] * (k + 1)
    for i in range(s - 1):
        to_light[i] = lp[0]["rev"] if i == 0 else lp[i]["rev"] * lp[i]["g"]
        to_eye[i] = lp[i]["fwd"] * lp[i + 1]["g"]
        delta[i] = lp[i]["delta"]
    if s > 0:
        to_light[s - 1] = end["s_rev"] if s == 1 else \
            end["s_rev"] * lp[s - 1]["g"]
        to_eye[s - 1] = end["s_fwd"] * end["g"]
        delta[s - 1] = lp[s - 1]["delta"]
    for j in range(t - 1):
        to_eye[k - j] = ep[j]["rev"] if j == 0 else ep[j]["rev"] * ep[j]["g"]
        to_light[k - j] = ep[j]["fwd"] * ep[j + 1]["g"]
        delta[k - j] = ep[j]["delta"]
    i = k - (t - 1)
    to_eye[i] = end["t_rev"] if t == 1 else end["t_rev"] * ep[t - 1]["g"]
    to_light[i] = end["t_fwd"] if s == 0 else end["t_fwd"] * end["g"]
    delta[i] = ep[t - 1]["delta"]

    def ratio(a, b):
        return a / torch.where(b.abs() < 1e-30, 1e-30, b)

    total = torch.ones_like(to_light[0])
    r = torch.ones_like(total)
    for i in range(s, k):           # the strategies with more light vertices
        if i == 0:
            r = r * ratio(to_light[0], to_light[1])
            off = delta[1]
        else:
            r = r * ratio(to_eye[i - 1], to_light[i + 1])
            off = delta[i] | delta[i + 1]
        total = total + torch.where(off, 0.0, r * r)
    r = torch.ones_like(total)
    for i in range(s, 0, -1):       # ... and with fewer
        if i == 1:
            r = r * ratio(to_light[1], to_light[0])
            off = delta[0]
        else:
            r = r * ratio(to_light[i], to_eye[i - 2])
            off = delta[i - 1] | delta[i - 2]
        total = total + torch.where(off, 0.0, r * r)
    w = 1.0 / total
    bad = torch.isnan(w) | torch.isinf(w) | (w < MIN_DIVISOR)
    return torch.where(bad, 0.0, w)


def _nonzero3(v):
    return (v != 0.0).any(-1)


def bdpt_lanes(scene: RefScene, cam: RefCamera, pixel, smp, seed: int,
               opts: dict, spp: int):
    """One BDPT sample per lane (lane = pixel, sample id ``smp``) ->
    (estimate [N, 3] for the lane's pixel, splat pixels [M] and splat
    values [M, 3]), the splats already over ``spp``."""
    length = int(opts["bdpt_max_path_length"])
    eta = scene.eta
    lane = pixel
    ep, pp = eye_path(scene, cam, pixel, lane, smp, seed, length)
    lp = light_path(scene, lane, smp, seed, length)
    we_pix, _ = cam.importance(pp)
    emission = lp[0]["emission"]
    n = pixel.shape[0]
    est = torch.zeros((n, 3), dtype=scene.dtype, device=pixel.device)
    v1 = ep[1]
    est = est + sel(v1["valid"] & (v1["m"]["mtype"] == UNLIT),
                    v1["m"]["diffuse"], torch.zeros_like(est))
    shadow = []       # (kind, lanes, rgb, splat pixel, o, d, dist)
    for length_ in range(1, length + 1):
        for s in range(length_ + 1):
            t = length_ + 1 - s
            if s == 0:
                if t == 1:
                    continue
                ev = ep[t - 1]
                contrib = ev["tp"] * ev["m"]["emission"] * we_pix[:, None]
                ok = ev["valid"] & ev["emissive"] & _nonzero3(contrib)
                pick = torch.where(ev["emissive"], 1.0 / (
                    scene.n_lights * torch.clamp(ev["area"], min=1e-20)),
                    0.0)
                w = mis_weight(ep, lp, 0, t, dict(t_fwd=pick, t_rev=_full(
                    n, 1.0 / PI, pick)))
                est = est + sel(ok, contrib * w[:, None],
                                torch.zeros_like(est))
                continue
            if t == 1:
                if s == 1:
                    continue
                lv = lp[s - 1]
                ok = lv["valid"] & ~lv["emissive"] & ep[1]["valid"]
                wi = normalize(cam.eye[None] - lv["pos"], 1e-20)
                wo = normalize(lp[s - 2]["pos"] - lv["pos"], 1e-20)
                f = bsdf_eval(lv["m"], wo, wi, lv["ng"], lv["ns"], eta)
                g = geo(cam.eye[None].expand_as(wi),
                        cam.fwd[None].expand_as(wi), lv["pos"], lv["ng"])
                we, pix = cam.importance(lv["pos"])
                o = lv["pos"] + sel(dot(wi, lv["ns"]) < 0.0, -lv["ns"],
                                    lv["ns"]) * EPSILON
                to_cam = cam.eye[None] - o
                dist = torch.sqrt(dot(to_cam, to_cam))
                ok = ok & (dot(wi, cam.fwd[None].expand_as(wi)) < 0.0) & \
                    (pix >= 0)
                w = mis_weight(ep, lp, s, t, end_pdfs(scene, cam, ep, lp, s,
                                                      t))
                rgb = emission * lv["tp"] * (g * we / spp)[:, None] * f * \
                    w[:, None]
                ok = ok & _nonzero3(rgb)
                shadow.append(("splat", ok, rgb, pix, o, to_cam *
                               (1.0 / torch.clamp(dist, min=1e-20))[:, None],
                               dist))
                continue
            lv, ev = lp[s - 1], ep[t - 1]
            ok = lv["valid"] & ev["valid"] & ~ev["emissive"]
            join = normalize(ev["pos"] - lv["pos"], 1e-20)
            e_wo = normalize(ep[t - 2]["pos"] - ev["pos"], 1e-20)
            f_e = bsdf_eval(ev["m"], -join, e_wo, ev["ng"], ev["ns"], eta)
            if s == 1:
                f_l = sel(dot(join, lv["ns"]) >= 0.0, torch.ones_like(f_e),
                          torch.zeros_like(f_e))
                l_o = lv["pos"] + lv["ns"] * EPSILON
            else:
                l_wo = normalize(lp[s - 2]["pos"] - lv["pos"], 1e-20)
                f_l = bsdf_eval(lv["m"], l_wo, join, lv["ng"], lv["ns"], eta)
                l_o = lv["pos"] + sel(dot(l_wo, lv["ns"]) < 0.0, -lv["ns"],
                                      lv["ns"]) * EPSILON
            e_o = ev["pos"] + sel(dot(e_wo, ev["ns"]) < 0.0, -ev["ns"],
                                  ev["ns"]) * EPSILON
            g = geo(ev["pos"], ev["ng"], lv["pos"], lv["ng"])
            seg = l_o - e_o
            dist = torch.sqrt(dot(seg, seg))
            w = mis_weight(ep, lp, s, t, end_pdfs(scene, cam, ep, lp, s, t))
            rgb = ev["tp"] * lv["tp"] * emission * (g * we_pix)[:, None] * \
                f_e * f_l * w[:, None]
            ok = ok & _nonzero3(rgb)
            shadow.append(("est", ok, rgb, None, e_o, seg * (
                1.0 / torch.clamp(dist, min=1e-20))[:, None], dist))
    # every valid connection's shadow ray in one any-hit walk
    lanes = [torch.nonzero(q[1])[:, 0] for q in shadow]
    cat = lambda j: torch.cat([q[j][i] for q, i in zip(shadow, lanes)])
    blocked = scene.occluded(cat(4), cat(5), cat(6)) if \
        sum(len(i) for i in lanes) else None
    at, spl_pix, spl_rgb = 0, [], []
    for (kind, _, rgb, pix, *_), i in zip(shadow, lanes):
        seen = i[~blocked[at:at + len(i)]] if len(i) else i
        at += len(i)
        if kind == "est":
            est = est.index_add(0, seen, rgb[seen])
        else:
            spl_pix.append(pix[seen])
            spl_rgb.append(rgb[seen])
    est = torch.where(torch.isnan(est).any(-1, keepdim=True), 0.0, est)
    return est, torch.cat(spl_pix), torch.cat(spl_rgb)


def render_film(scene: RefScene, cam_cfg: dict, width: int, height: int,
                samples, seed: int, opts: dict, block: int = BLOCK):
    """The film of one BDPT render over the sample ids ``samples`` ->
    [height * width, 3] float32: the background, each pixel's estimates
    over ``len(samples)``, and every splat (already over that count); a
    pixel that is not a number reads 0. Lanes go in blocks of
    ``block``."""
    for flag, value in MODELLED.items():
        if opts.get(flag, value) != value:
            raise ValueError(f"the BDPT reference models {flag}={value} "
                             "alone")
    dev = samples.device
    cam = RefCamera(cam_cfg, width, height, scene.dtype, dev)
    p = width * height
    spp = len(samples)
    sums = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    splats = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    pixel = torch.arange(p, device=dev).repeat(spp)
    smp = samples.repeat_interleave(p)
    for lo in range(0, len(pixel), block):
        px, sm = pixel[lo:lo + block], smp[lo:lo + block]
        est, spix, srgb = bdpt_lanes(scene, cam, px, sm, seed, opts, spp)
        sums.index_add_(0, px, est.float())
        splats.index_add_(0, spix, srgb.float())
    film = scene.bkg.float()[None] + sums * (1.0 / spp) + splats
    return torch.where(torch.isnan(film), 0.0, film)
