"""The plain reference: a unidirectional path tracer in plain PyTorch.

It computes what the program's path tracer computes (NEE with the power
heuristic's MIS, Russian roulette gated by ``min_depth``, the dielectric
branch with total internal reflection, the kill thresholds at
``MIN_DIVISOR``), lane by lane, from the scene arrays and the camera of the
configuration and the frozen random numbers of ``ref_rng``. It shares no
code with the program. It differs from it in structure:

- each bounce works only on the lanes that are still alive, gathered by
  index and scattered back, where the program masks full-width columns;
- rays meet triangles through Moller-Trumbore tests, either against every
  triangle or through its own bounding-volume hierarchy (a Morton-ordered
  implicit binary tree over leaves of four triangles, walked with a stack
  per ray), where the program uses Woop rows and its own kernels and
  tables;
- every quantity is an [N, 3] or [N] tensor of one dtype, so the same code
  runs in float32 (the configuration's precision) and in bfloat16 (the
  control).

Under ``differentiable=True`` the sampling decisions are detached where the
program detaches them (sampled directions, light points and pdfs, MIS
weights, Russian-roulette probabilities), so autograd through it gives the
same detached-sampling gradient of the material leaves.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import ref_rng as rng

EPSILON = 5e-4
MIN_DIVISOR = 0.04
FEQ = 1e-4
PARALLEL_EPS = 1e-4
PI = float(np.float32(math.pi))
BIG = 3.0e38

LAMBERTIAN, MIRROR, GLASS, ROUGH, ROUGH_T, UNLIT = range(6)
FROM_CAMERA, FROM_BSDF, FROM_REFRACT = 0, 1, 2
BRUTE_FORCE_MAX = 64          # triangles tested all at once below this
LEAF = 4                      # triangles per leaf of the reference's tree


# ------------------------------------------------------------ vector helpers

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v, eps: float = 0.0):
    if eps:
        floor = eps * eps if eps * eps >= torch.finfo(v.dtype).tiny else 0.0
        return v * torch.rsqrt(torch.clamp(dot(v, v), min=floor))[..., None]
    return v * (1.0 / torch.sqrt(dot(v, v)))[..., None]


def sel(mask, a, b):
    """``mask`` [N] picks rows of ``a`` or ``b`` ([N, 3] or [N])."""
    if torch.is_tensor(a) and a.dim() == 2 or torch.is_tensor(b) and \
            b.dim() == 2:
        mask = mask[:, None]
    return torch.where(mask, a, b)


def reflect(i, n):
    return n * (2.0 * dot(n, i))[..., None] - i


def refract(i, n, eta_i, eta_t):
    cos_i = torch.clamp(dot(n, i), -1.0, 1.0)
    n = sel(cos_i < 0.0, -n, n)
    cos_i = cos_i.abs()
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = (eta_i / eta_t) * sin_i
    tir = sin_i > (eta_t / eta_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    d = -n * cos_t[:, None] + (n * cos_i[:, None] - i) * \
        (eta_i / eta_t)[:, None]
    return sel(tir, torch.zeros_like(d), d), tir


def to_world(n, lx, ly, lz):
    big = n[:, 0].abs() > 0.9
    helper = torch.zeros_like(n)
    helper[:, 0] = torch.where(big, 0.0, 1.0)
    helper[:, 1] = torch.where(big, 1.0, 0.0)
    s = normalize(cross(n, helper), 1e-20)
    t = cross(n, s)
    return normalize(s * lx[:, None] + t * ly[:, None] + n * lz[:, None],
                     1e-20)


def safe_div(a, b):
    ok = b != 0.0
    return a / torch.where(ok, b, 1.0) * ok.to(a.dtype)


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def fresnel_ior(i, n, eta_i, eta_t):
    c = dot(i, n).abs()
    f0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
    return f0 + (1.0 - f0) * pow5(torch.clamp(1.0 - c, 0.0, 1.0))


def ggx_d(h, n, rough):
    a = torch.clamp(rough * rough, min=1e-3)
    nh = dot(n, h)
    c2 = nh * nh
    s = a * a * c2 + (1.0 - c2)
    d = torch.where(s == 0.0, 1.0, (a * a) / (PI * torch.clamp(s * s,
                                                               min=1e-30)))
    return torch.where(nh < 0.0, 0.0, d)


def smith_g(wi, wo, n, rough, h):
    a = torch.clamp(rough * rough, min=1e-3)

    def g1(w):
        c = dot(w, n)
        c2 = c * c
        pos = c2 > 0.0
        tan2 = torch.where(pos, (1.0 - c2) / torch.where(pos, c2, 1.0), 1e30)
        g = 2.0 / (1.0 + torch.sqrt(1.0 + a * a *
                                    torch.clamp(tan2, 0.0, 1e30)))
        ok = (dot(w, h) * torch.sign(c)) >= 0.0
        return torch.where(ok & pos, g, 0.0)
    return g1(wi) * g1(wo)


def mis(pdf, other):
    s = pdf + other
    return safe_div(pdf * pdf, s * s)


# ------------------------------------------------------------- materials

def bsdf_eval(m, wi, wo, ng, ns, eta_scene, tir=None):
    """The BSDF value f(wi, wo) times the shading-normal correction."""
    t = m["mtype"]
    if tir is None:
        tir = torch.zeros_like(t, dtype=torch.bool)
    zero = torch.zeros_like(wi)
    reject = (dot(wi, ng) * dot(wi, ns) <= 0.0) | \
        (dot(wo, ng) * dot(wo, ns) <= 0.0)
    corr = dot(wi, ns).abs() / torch.clamp(dot(wi, ng).abs(), min=1e-20)
    out = zero
    types = set(t.unique().tolist())
    if LAMBERTIAN in types:
        lam = sel(dot(wi, ns) >= 0.0, m["diffuse"] * (corr / PI)[:, None],
                  zero)
        out = sel(t == LAMBERTIAN, lam, out)
    if ROUGH in types:
        h = normalize(wi + wo, 1e-20)
        f0 = 0.04 + (m["diffuse"] - 0.04) * m["metallic"][:, None]
        f = f0 + (1.0 - f0) * pow5(torch.clamp(1.0 - dot(h, wi), 0.0,
                                               1.0))[:, None]
        dg = smith_g(wi, wo, ns, m["rough"], h) * ggx_d(h, ns, m["rough"])
        denom = 4.0 * dot(wi, ns) * dot(wo, ns)
        ok = denom != 0.0
        spec = (f * dg[:, None]) * ((1.0 / torch.where(ok, denom, 1.0)) *
                                    ok.to(dg.dtype))[:, None]
        rough = (spec + (1.0 - f) * m["diffuse"] * (1.0 / PI)) * corr[:, None]
        out = sel(t == ROUGH, rough, out)
    if ROUGH_T in types:
        flip = dot(wo, ns) < 0.0
        n = sel(flip, -ns, ns)
        ei = torch.where(flip, m["eta"], eta_scene)
        et = torch.where(flip, eta_scene, m["eta"])
        h = normalize(wo + wi, 1e-20)
        fr = torch.where(tir, 1.0, fresnel_ior(wi, h, ei, et))
        v_r = safe_div(fr * smith_g(wi, wo, n, m["rough"], h) *
                       ggx_d(h, n, m["rough"]),
                       4.0 * dot(wi, n) * dot(wo, n))
        ht = -normalize(wo * ei[:, None] + wi * et[:, None], 1e-20)
        ht = sel(dot(ht, n) < 0.0, -ht, ht)
        cih, coh = dot(wi, ht), dot(wo, ht)
        ft = fresnel_ior(wi, ht, ei, et)
        num = cih.abs() * coh.abs() * et * et * (1.0 - ft) * \
            smith_g(wi, wo, n, m["rough"], ht) * ggx_d(ht, n, m["rough"])
        den = dot(wi, n).abs() * dot(wo, n).abs() * (ei * cih + et * coh) ** 2
        v = torch.where(dot(wi, n) >= 0.0, v_r, safe_div(num, den)) * corr
        out = sel(t == ROUGH_T, v[:, None].expand_as(wi), out)
    if MIRROR in types:
        aligned = (dot(normalize(wi + wo, 1e-20), ns) - 1.0).abs() < FEQ
        v = torch.where(aligned, corr / torch.clamp(dot(ns, wi).abs(),
                                                    min=1e-20), 0.0)
        out = sel(t == MIRROR, v[:, None].expand_as(wi), out)
    if GLASS in types:
        flip = dot(wo, ns) < 0.0
        n = sel(flip, -ns, ns)
        ei = torch.where(flip, m["eta"], eta_scene)
        et = torch.where(flip, eta_scene, m["eta"])
        f = fresnel_ior(wi, n, ei, et)
        rdir = normalize(reflect(wo, ns), 1e-20)
        tdir = normalize(refract(wo, n, ei, et)[0], 1e-20)
        n2 = sel(dot(n, wi) < 0.0, -n, n)
        c = dot(n2, wi)
        inv_cos = 1.0 / torch.where(c == 0.0, 1e-20, c)
        v = torch.where(
            tir, inv_cos * corr,
            torch.where((dot(wi, rdir) - 1.0).abs() < FEQ, f * inv_cos * corr,
                        torch.where((dot(wi, tdir) - 1.0).abs() < FEQ,
                                    (1.0 - f) * inv_cos * corr, 0.0)))
        out = sel(t == GLASS, v[:, None].expand_as(wi), out)
    transmissive = (t == ROUGH_T) | (t == GLASS)
    return sel(reject & ~transmissive, zero, out)


def _ggx_half(n, r0, r1, a2):
    phi = 2.0 * PI * r1
    c = torch.sqrt(torch.clamp((1.0 - r0) / (r0 * (a2 - 1.0) + 1.0),
                               0.0, 1.0))
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    return to_world(n, s * torch.cos(phi), s * torch.sin(phi), c)


def bsdf_sample(m, wo, n, r0, r1, lottery, eta_scene):
    """-> (wi, success, tir): a direction drawn from the material."""
    t = m["mtype"]
    types = set(t.unique().tolist())
    won = dot(wo, n)
    flip = won < 0.0
    nt = sel(flip, -n, n)
    ei = torch.where(flip, m["eta"], eta_scene)
    et = torch.where(flip, eta_scene, m["eta"])
    r2 = m["rough"] * m["rough"]
    cos_l = torch.sqrt(torch.clamp(r0, min=1e-12))
    sin_l = torch.sqrt(torch.clamp(1.0 - r0, min=1e-12))
    phi = 2.0 * PI * r1
    wi = to_world(n, torch.cos(phi) * sin_l, torch.sin(phi) * sin_l, cos_l)
    success = torch.where(t == LAMBERTIAN, (won > 0.0) & (dot(wi, n) >= 0.0),
                          t != UNLIT)
    tir = torch.zeros_like(success)
    if ROUGH in types:
        h = _ggx_half(n, r0, r1, torch.clamp(r2, min=1e-3) ** 2)
        w_r = normalize(reflect(wo, h), 1e-20)
        wi = sel(t == ROUGH, w_r, wi)
        success = torch.where(t == ROUGH, (won > 0.0) & (dot(w_r, n) > 0.0),
                              success)
    if ROUGH_T in types:
        a = torch.clamp(r2, min=1e-3)
        h = _ggx_half(nt, r0, r1, a * a)
        w_t, tir_t = refract(wo, h, ei, et)
        w_t = sel(lottery < fresnel_ior(wo, h, ei, et), reflect(wo, h), w_t)
        wi = sel(t == ROUGH_T, w_t, wi)
        tir = torch.where(t == ROUGH_T, tir_t, tir)
    if MIRROR in types:
        wi = sel(t == MIRROR, reflect(wo, n), wi)
    if GLASS in types:
        w_g, tir_g = refract(wo, nt, ei, et)
        w_g = sel(lottery < fresnel_ior(wo, nt, ei, et), reflect(wo, nt), w_g)
        wi = sel(t == GLASS, w_g, wi)
        tir = torch.where(t == GLASS, tir_g, tir)
    wi = sel(tir, torch.zeros_like(wi), wi)
    return normalize(wi, 1e-20), success, tir


def bsdf_pdf(m, wi, wo, n, eta_scene):
    """The solid-angle pdf of drawing ``wi`` from the material."""
    t = m["mtype"]
    types = set(t.unique().tolist())
    out = torch.ones_like(wi[:, 0])
    if LAMBERTIAN in types:
        c = dot(wi, n)
        out = torch.where(t == LAMBERTIAN,
                          torch.where(c > 0.0, torch.clamp(c, min=0.0) / PI,
                                      0.0), out)
    h = normalize(wo + wi, 1e-20)
    if ROUGH in types:
        out = torch.where(t == ROUGH, safe_div(
            ggx_d(h, n, m["rough"]) * torch.clamp(dot(n, h), min=0.0),
            4.0 * dot(wo, h)), out)
    flip = dot(wo, n) < 0.0
    nt = sel(flip, -n, n)
    ei = torch.where(flip, m["eta"], eta_scene)
    et = torch.where(flip, eta_scene, m["eta"])
    if ROUGH_T in types:
        f = fresnel_ior(wo, nt, ei, et)
        p_r = safe_div(f * ggx_d(h, nt, m["rough"]) * dot(nt, h).abs(),
                       4.0 * dot(wo, h))
        ht = -normalize(wo * ei[:, None] + wi * et[:, None], 1e-20)
        c = dot(nt, ht)
        ht = sel(c < 0.0, -ht, ht)
        dsq = ei * dot(wi, ht) + et * dot(wo, ht)
        jac = safe_div(et * et * dot(wo, ht).abs(), dsq * dsq)
        p_t = (1.0 - f) * ggx_d(ht, nt, m["rough"]) * c.abs() * jac
        out = torch.where(t == ROUGH_T,
                          torch.where(dot(wi, nt) >= 0.0, p_r, p_t), out)
    if MIRROR in types:
        out = torch.where(t == MIRROR,
                          ((dot(h, n) - 1.0).abs() < FEQ).to(out.dtype), out)
    if GLASS in types:
        rdir = normalize(reflect(wo, n), 1e-20)
        tdir = normalize(refract(wo, nt, ei, et)[0], 1e-20)
        f = fresnel_ior(wo, nt, ei, et)
        out = torch.where(t == GLASS, torch.where(
            (dot(wi, rdir) - 1.0).abs() < FEQ, f,
            torch.where((dot(wi, tdir) - 1.0).abs() < FEQ, 1.0 - f, 0.0)),
            out)
    return out


# ----------------------------------------------------------------- scene

class RefScene:
    """The scene as the reference holds it: triangle corners and vertex
    normals, their own geometric normals and areas, spheres, the material
    table, the light list and, for large meshes, the reference's own
    tree."""

    def __init__(self, arrays: dict, device, dtype=torch.float32):
        self.dtype, self.device = dtype, device
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=device).to(dtype)
        i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        tv = [v for v, _, _ in arrays["tris"]]
        verts = np.concatenate(tv, 0) if tv else np.zeros((0, 3, 3),
                                                          np.float32)
        normals = []
        for v, nrm, _ in arrays["tris"]:
            if nrm is None:
                fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                fn = fn / np.maximum(np.linalg.norm(fn, axis=1,
                                                    keepdims=True), 1e-20)
                nrm = np.repeat(fn[:, None, :], 3, axis=1)
            normals.append(np.asarray(nrm, np.float32))
        normals = np.concatenate(normals, 0) if normals else verts
        tmat = np.concatenate([np.full(len(v), m) for v, _, m in
                               arrays["tris"]]) if tv else np.zeros(0)
        self.v0, self.v1, self.v2 = (f(verts[:, k]) for k in range(3))
        self.n0, self.n1, self.n2 = (f(normals[:, k]) for k in range(3))
        c = cross(self.v1 - self.v0, self.v2 - self.v0)
        cn = torch.sqrt(dot(c, c))
        self.ng = c / torch.clamp(cn, min=1e-30)[:, None]
        self.area = 0.5 * cn
        self.tmat = i(tmat)
        sp = arrays["spheres"]
        self.sc = f([s[0] for s in sp]).reshape(-1, 3)
        self.sr = f([s[1] for s in sp])
        self.smat = i([s[2] for s in sp])
        self.sarea = 4.0 * PI * self.sr * self.sr
        mats = arrays["materials"]
        self.mtype = i([m["mtype"] for m in mats])
        self.eta_m = f([m["eta"] for m in mats])
        self.set_materials(
            [f([m[k][j] for m in mats]) for k in ("diffuse", "emission")
             for j in range(3)] +
            [f([m["roughness"] for m in mats]),
             f([m["metallic"] for m in mats])])
        self.bkg = f(arrays["bkgcolor"])
        self.eta = torch.tensor(arrays["eta"], dtype=dtype, device=device)
        # lights: every emissive triangle, then every emissive sphere
        emissive = np.asarray([np.any(np.asarray(m["emission"]) != 0)
                               for m in mats])
        lt = np.nonzero(emissive[tmat.astype(np.int64)])[0] if len(tmat) \
            else np.zeros(0, np.int64)
        ls = np.nonzero(emissive[np.asarray([s[2] for s in sp],
                                            np.int64)])[0] if sp \
            else np.zeros(0, np.int64)
        self.light_tri, self.light_sph = i(lt), i(ls)
        self.n_lights = len(lt) + len(ls)
        # small scenes are tested whole; a large one goes into the tree,
        # but for its few triangles far larger than the rest (a ground
        # plane), whose boxes would widen every box above them
        ids = np.arange(len(verts))
        self.tree = None
        if len(verts) > BRUTE_FORCE_MAX:
            diag = np.linalg.norm(verts.max(1) - verts.min(1), axis=1)
            big = diag > 16.0 * np.median(diag)
            self.tree = _Tree(self, verts, ids[~big])
            ids = ids[big]
        self.loose = i(ids)

    def set_materials(self, leaves):
        """Install the eight differentiable [M] columns of the material
        table: diffuse x y z, emission x y z, roughness, metallic. The
        lights' emission is read from the table, so it follows."""
        lv = [a.to(self.dtype) for a in leaves]
        self.diffuse = torch.stack(lv[0:3], -1)
        self.emission = torch.stack(lv[3:6], -1)
        self.rough, self.metal = lv[6], lv[7]

    def material(self, mat):
        return dict(mtype=self.mtype[mat], diffuse=self.diffuse[mat],
                    emission=self.emission[mat], rough=self.rough[mat],
                    metallic=self.metal[mat], eta=self.eta_m[mat])

    def emissive(self, mat):
        return (self.emission[mat] != 0.0).any(-1)

    # ------------------------------------------------------ intersection

    def _tri_test(self, o, d, v0, v1, v2, ng):
        """Moller-Trumbore of rays o, d [..., 3] against triangles
        broadcast beside them -> (t, u, v, ok)."""
        e1, e2 = v1 - v0, v2 - v0
        p = cross(d, e2)
        det = dot(e1, p)
        inv = 1.0 / torch.where(det == 0.0, 1.0, det)
        s = o - v0
        u = dot(s, p) * inv
        q = cross(s, e1)
        v = dot(d, q) * inv
        t = dot(e2, q) * inv
        ok = (dot(d, ng).abs() >= PARALLEL_EPS) & (det != 0.0) & (t > 0.0) \
            & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0)
        return t, u, v, ok

    def _spheres(self, o, d):
        """Nearest sphere root of each ray -> (t or BIG, index)."""
        n = o.shape[0]
        if not len(self.sr):
            return torch.full((n,), BIG, dtype=o.dtype, device=o.device), \
                torch.zeros(n, dtype=torch.long, device=o.device)
        l = o[:, None, :] - self.sc[None]
        b = dot(d[:, None, :], l)
        c = dot(l, l) - self.sr[None] ** 2
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1, t2 = -b - sq, -b + sq
        t = torch.where(t1 > 0.0, t1, t2)
        t = torch.where((disc >= 0.0) & (t > 0.0), t, BIG)
        best, j = t.min(1)
        return best, j

    def _loose(self, o, d):
        """Moller-Trumbore against every triangle outside the tree ->
        (t, u, v, ok), each [N, L]."""
        k = self.loose
        return self._tri_test(o[:, None], d[:, None], self.v0[k][None],
                              self.v1[k][None], self.v2[k][None],
                              self.ng[k][None])

    def nearest(self, o, d):
        """-> dict(t, hit, is_tri, prim, u, v) for rays o, d [N, 3]."""
        n = o.shape[0]
        t = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
        prim = torch.zeros(n, dtype=torch.long, device=o.device)
        bu = bv = torch.zeros_like(t)
        if len(self.loose):
            tl, ul, vl, ok = self._loose(o, d)
            tl = torch.where(ok, tl, BIG)
            t, j = tl.min(1)
            prim = self.loose[j]
            bu = ul.gather(1, j[:, None])[:, 0]
            bv = vl.gather(1, j[:, None])[:, 0]
        if self.tree is not None:
            tt, pt, ut, vt = self.tree.walk(o, d, None)
            closer = tt < t
            t, prim = torch.where(closer, tt, t), torch.where(closer, pt, prim)
            bu, bv = torch.where(closer, ut, bu), torch.where(closer, vt, bv)
        ts, js = self._spheres(o, d)
        sph = ts < t
        return dict(t=torch.where(sph, ts, t), hit=torch.minimum(ts, t) < BIG,
                    is_tri=~sph, prim=torch.where(sph, js, prim), u=bu, v=bv)

    def occluded(self, o, d, dist):
        """Whether anything lies on the segment: a hit with t < dist and
        |t - dist| >= 1e-4."""
        blocked = torch.zeros_like(dist, dtype=torch.bool)
        if len(self.loose):
            t, _, _, ok = self._loose(o, d)
            dd = dist[:, None]
            blocked = (ok & (t < dd) & ((t - dd).abs() >= PARALLEL_EPS)).any(1)
        if self.tree is not None:
            blocked = blocked | self.tree.walk(o, d, dist)
        ts, _ = self._spheres(o, d)
        return blocked | ((ts < BIG) & (ts < dist) &
                          ((ts - dist).abs() >= PARALLEL_EPS))

    def shade(self, o, d, h):
        """Position, geometric and shading normals, material and area of
        each hit (material 0 where nothing was hit)."""
        t = torch.where(h["hit"], h["t"], 1.0)
        pos = o + d * t[:, None]
        tri = h["is_tri"]
        n = o.shape[0]
        if len(self.tmat):
            k = torch.where(tri, h["prim"], 0)
            w = 1.0 - h["u"] - h["v"]
            ns_t = normalize(self.n0[k] * w[:, None] + self.n1[k] *
                             h["u"][:, None] + self.n2[k] * h["v"][:, None],
                             1e-30)
            ng_t, mat_t, area_t = self.ng[k], self.tmat[k], self.area[k]
        else:
            ns_t = ng_t = torch.zeros_like(o)
            mat_t = torch.zeros(n, dtype=torch.long, device=o.device)
            area_t = torch.zeros_like(t)
        if len(self.sr):
            k = torch.where(tri, 0, h["prim"])
            n_s = normalize(pos - self.sc[k], 1e-30)
            ng = sel(tri, ng_t, n_s)
            ns = sel(tri, ns_t, n_s)
            mat = torch.where(tri, mat_t, self.smat[k])
            area = torch.where(tri, area_t, self.sarea[k])
        else:
            ng, ns, mat, area = ng_t, ns_t, mat_t, area_t
        mat = torch.where(h["hit"], mat, 0)
        return pos, ng, ns, mat, area

    # ------------------------------------------------------------ lights

    def sample_light(self, r_pick, r0, r1):
        """-> (position, normal, emission, pdf per area) of a point drawn
        on a light picked uniformly."""
        nl = self.n_lights
        pick = torch.clamp((r_pick * nl).to(torch.int32), max=nl - 1).long()
        ntl = len(self.light_tri)
        is_sph = pick >= ntl
        ti = self.light_tri[torch.clamp(pick, max=max(ntl - 1, 0))] if ntl \
            else None
        su = torch.sqrt(torch.clamp(r0, min=0.0))
        u = 1.0 - su
        v = r1 * su
        w = 1.0 - u - v
        if ntl:
            pos = self.v0[ti] * w[:, None] + self.v1[ti] * u[:, None] + \
                self.v2[ti] * v[:, None]
            ng = normalize(self.n0[ti] * w[:, None] + self.n1[ti] * u[:, None]
                           + self.n2[ti] * v[:, None], 1e-20)
            mat, area = self.tmat[ti], self.area[ti]
        if len(self.light_sph):
            si = self.light_sph[torch.clamp(pick - ntl, min=0)]
            c, r = self.sc[si], self.sr[si]
            th, ph = r0 * 2.0 * PI, r1 * PI
            sp = c + r[:, None] * torch.stack(
                [torch.cos(th) * torch.sin(ph), torch.sin(th) * torch.sin(ph),
                 torch.cos(ph)], -1)
            sn = normalize(sp - c, 1e-20)
            if ntl:
                pos, ng = sel(is_sph, sp, pos), sel(is_sph, sn, ng)
                mat = torch.where(is_sph, self.smat[si], mat)
                area = torch.where(is_sph, self.sarea[si], area)
            else:
                pos, ng, mat, area = sp, sn, self.smat[si], self.sarea[si]
        return pos, ng, self.emission[mat], 1.0 / (nl * area)


class _Tree:
    """The reference's bounding-volume hierarchy: triangles sorted by the
    Morton code of their centroids, cut into leaves of ``LEAF``, under an
    implicit complete binary tree (node k has children 2k+1 and 2k+2) whose
    boxes are the unions of their children's, widened a little so that
    rounding never culls a hit."""

    def __init__(self, scene: RefScene, verts: np.ndarray, ids: np.ndarray):
        lo = verts.min(1).astype(np.float64)
        hi = verts.max(1).astype(np.float64)
        cen = 0.5 * (lo[ids] + hi[ids])
        span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
        q = np.clip(((cen - cen.min(0)) / span * 1023).astype(np.int64),
                    0, 1023)
        code = np.zeros(len(q), np.int64)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
        order = np.argsort(code, kind="stable")
        n_leaves = -(-len(order) // LEAF)
        p = 1 << max(0, (n_leaves - 1).bit_length())
        slots = np.full(p * LEAF, -1, np.int64)
        slots[:len(order)] = ids[order]
        leaf_tri = slots.reshape(p, LEAF)
        valid = leaf_tri >= 0
        safe = np.where(valid, leaf_tri, 0)
        blo = np.where(valid[..., None], lo[safe], np.inf).min(1)
        bhi = np.where(valid[..., None], hi[safe], -np.inf).max(1)
        los, his = [blo], [bhi]
        while len(los[-1]) > 1:
            a, b = los[-1], his[-1]
            los.append(np.minimum(a[0::2], a[1::2]))
            his.append(np.maximum(b[0::2], b[1::2]))
        lo_all = np.concatenate(los[::-1])
        hi_all = np.concatenate(his[::-1])
        pad = 1e-4 * np.maximum(1.0, np.abs(np.concatenate([lo_all, hi_all])
                                            [np.isfinite(np.concatenate(
                                                [lo_all, hi_all]))]).max())
        dev = scene.device
        self.lo = torch.as_tensor(lo_all - pad, dtype=torch.float32,
                                  device=dev)
        self.hi = torch.as_tensor(hi_all + pad, dtype=torch.float32,
                                  device=dev)
        # the padding's leaves and the nodes over them hold nothing
        self.filled = (self.lo <= self.hi).all(-1)
        self.first_leaf = p - 1
        self.leaf_tri = torch.as_tensor(leaf_tri, device=dev)
        self.depth = int(np.log2(p)) + 2
        self.scene = scene

    def _box(self, o, inv, node, t_max):
        """Entry distance of each ray into node's box, BIG where it misses,
        enters beyond t_max or the node holds no triangle. Float32,
        whatever the scene's dtype."""
        lo = (self.lo[node] - o) * inv
        hi = (self.hi[node] - o) * inv
        lo = torch.nan_to_num(lo, nan=-BIG)
        hi = torch.nan_to_num(hi, nan=BIG)
        tn = torch.clamp(torch.minimum(lo, hi).max(-1).values, min=0.0)
        tf = torch.maximum(lo, hi).min(-1).values
        ok = (tn <= tf) & (tn <= t_max) & self.filled[node]
        return torch.where(ok, tn, BIG)

    def walk(self, o, d, dist):
        """Nearest hit (dist None) -> (t, prim, u, v); or, with a dist per
        ray, whether the segment is blocked."""
        sc = self.scene
        n = o.shape[0]
        dev = o.device
        of, df = o.float(), d.float()
        inv = 1.0 / df
        any_hit = dist is not None
        best = torch.full((n,), BIG, dtype=o.dtype, device=dev)
        prim = torch.zeros(n, dtype=torch.long, device=dev)
        bu = torch.zeros(n, dtype=o.dtype, device=dev)
        bv = torch.zeros_like(bu)
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        limit = dist.float() + 1.0 if any_hit else \
            torch.full((n,), BIG, device=dev)
        stack = torch.zeros((n, 2 * self.depth + 2), dtype=torch.long,
                            device=dev)
        sp = torch.zeros(n, dtype=torch.long, device=dev)
        root = torch.zeros(n, dtype=torch.long, device=dev)
        hit0 = self._box(of, inv, root, limit) < BIG
        sp[hit0] = 1
        act = torch.nonzero(sp > 0)[:, 0]
        while len(act):
            top = sp[act] - 1
            node = stack[act, top]
            sp[act] = top
            leaf = node >= self.first_leaf
            # inner nodes: push the children the ray enters, nearer on top
            ia = act[~leaf]
            if len(ia):
                nd = node[~leaf]
                c1, c2 = 2 * nd + 1, 2 * nd + 2
                lim = best[ia].float() if not any_hit else limit[ia]
                t1 = self._box(of[ia], inv[ia], c1, lim)
                t2 = self._box(of[ia], inv[ia], c2, lim)
                near_first = t1 <= t2
                far = torch.where(near_first, c2, c1)
                near = torch.where(near_first, c1, c2)
                t_far = torch.maximum(t1, t2)
                t_near = torch.minimum(t1, t2)
                s = sp[ia]
                put_far = t_far < BIG
                stack[ia[put_far], s[put_far]] = far[put_far]
                s = s + put_far.long()
                put_near = t_near < BIG
                stack[ia[put_near], s[put_near]] = near[put_near]
                sp[ia] = s + put_near.long()
            # leaves: test their triangles
            il = act[leaf]
            if len(il):
                tri = self.leaf_tri[node[leaf] - self.first_leaf]   # [k, 4]
                ok_slot = tri >= 0
                tri = torch.clamp(tri, min=0)
                t, u, v, ok = sc._tri_test(
                    o[il][:, None], d[il][:, None], sc.v0[tri], sc.v1[tri],
                    sc.v2[tri], sc.ng[tri])
                ok = ok & ok_slot
                if any_hit:
                    dd = dist[il][:, None]
                    hit = (ok & (t < dd) & ((t - dd).abs() >= PARALLEL_EPS)) \
                        .any(1)
                    blocked[il] = blocked[il] | hit
                    sp[il[hit]] = 0
                else:
                    t = torch.where(ok, t, BIG)
                    tmin, j = t.min(1)
                    better = tmin < best[il]
                    ib = il[better]
                    jb = j[better][:, None]
                    best[ib] = tmin[better]
                    prim[ib] = tri[better].gather(1, jb)[:, 0]
                    bu[ib] = u[better].gather(1, jb)[:, 0]
                    bv[ib] = v[better].gather(1, jb)[:, 0]
            act = torch.nonzero(sp > 0)[:, 0]
        if any_hit:
            return blocked
        return best, prim, bu, bv


# ------------------------------------------------------------------ camera

def camera_rays(cam_cfg: dict, width: int, height: int, pixel, dtype,
                device):
    """Origins and unit directions of the camera rays through the centres
    of pixels ``pixel`` (row-major ids) of a pinhole camera whose image
    plane lies at the distance where a pixel has unit area; the grid steps
    (ur - ul) / (width - 1) and (ll - ul) / (height - 1)."""
    eye = np.asarray(cam_cfg["eye"], np.float64)
    fwd = np.asarray(cam_cfg["viewdir"], np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(cam_cfg["updir"], np.float64))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    up = up / np.linalg.norm(up)
    tan_half = math.tan(math.radians(cam_cfg["hfov"] * 0.5))
    dist = width / (2.0 * tan_half)
    half_w = abs(tan_half * dist)
    half_h = half_w / (width / height)
    centre = eye + dist * fwd
    ul = centre - half_w * right + half_h * up
    ur = centre + half_w * right + half_h * up
    ll = centre - half_w * right - half_h * up
    dh = (ur - ul) / (width - 1)
    dv = (ll - ul) / (height - 1)
    off = (ur - ul) / (2.0 * width) + (ll - ul) / (2.0 * height)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device).to(dtype)
    px = (pixel % width).to(dtype)[:, None]
    py = (pixel // width).to(dtype)[:, None]
    p = t(ul)[None] + t(dh)[None] * px + t(dv)[None] * py + t(off)[None]
    o = t(eye)[None].expand_as(p)
    return o, normalize(p - o)


# ------------------------------------------------------------- the tracer

def trace(scene: RefScene, o, d, lane, smp, seed: int, opts: dict,
          differentiable: bool = False):
    """Radiance [N, 3] of one path per lane from rays o, d: the estimator
    of the program's MIS path tracer. ``lane`` and ``smp`` [N] key the
    random numbers; ``opts`` holds max_depth, min_depth and
    russian_roulette."""
    n, dt, dev = o.shape[0], scene.dtype, o.device
    sg = (lambda x: x.detach()) if differentiable else (lambda x: x)
    one3 = lambda k: torch.ones((k, 3), dtype=dt, device=dev)
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    st = dict(o=o, d=d, w=one3(n), tp=one3(n), w_em=torch.zeros_like(L),
              fk=torch.zeros(n, dtype=torch.long, device=dev),
              prev_pdf=torch.zeros(n, dtype=dt, device=dev),
              mirror1=torch.zeros(n, dtype=torch.bool, device=dev),
              rr_inv=torch.zeros(n, dtype=dt, device=dev),
              cont_ok=torch.zeros(n, dtype=torch.bool, device=dev),
              em_ok=torch.zeros(n, dtype=torch.bool, device=dev))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    eta0 = scene.eta

    def mis_emission(s, d_, h, ns, mat, area, gate):
        """The MIS-weighted emission a BSDF-sampled ray finds on a light."""
        em = scene.emissive(mat)
        lpdf = torch.where(em, 1.0 / (scene.n_lights *
                                      torch.clamp(area, min=1e-20)), 0.0)
        cos_p = dot(normalize(ns, 1e-20), -d_)
        t = torch.where(h["hit"], h["t"], 1.0)
        lpdf_sa = lpdf * (t * t) / torch.clamp(cos_p, min=1e-20)
        wm = sg(mis(s["prev_pdf"], lpdf_sa))
        wm = torch.where(s["mirror1"], 1.0, wm)
        good = gate & em & (s["fk"] == FROM_BSDF) & (cos_p > 0.0) & \
            s["em_ok"] & (lpdf > 0.0)
        return sel(good, s["w_em"] * torch.where(good, wm, 0.0)[:, None] *
                   scene.emission[mat], torch.zeros_like(s["w_em"]))

    for depth in range(opts["max_depth"] + 1):
        idx = torch.nonzero(alive)[:, 0]
        if not len(idx):
            break
        s = {k: v[idx] for k, v in st.items()}
        u = lambda purpose: rng.uniform(seed, lane[idx], smp[idx], depth,
                                        purpose).to(dt)
        o_, d_ = s["o"], s["d"]
        h = scene.nearest(o_, d_)
        pos, ng, ns, mat, area = scene.shade(o_, d_, h)
        m = scene.material(mat)
        wo = -d_
        k = len(idx)
        zero3 = torch.zeros((k, 3), dtype=dt, device=dev)
        w = s["w"]
        add = sel(~h["hit"] & (s["fk"] != FROM_BSDF), w * scene.bkg, zero3)
        a = h["hit"].clone()
        em = scene.emissive(mat) & a
        add = add + sel(em & (s["fk"] == FROM_CAMERA), w * m["emission"],
                        zero3)
        add = add + mis_emission(s, d_, h, ns, mat, area, em)
        a = a & ~em
        unlit = a & (m["mtype"] == UNLIT)
        w_cont = s["w_em"] * s["rr_inv"][:, None]
        add = add + sel(unlit & (s["fk"] != FROM_BSDF), w * m["diffuse"],
                        zero3)
        add = add + sel(unlit & (s["fk"] == FROM_BSDF) & s["cont_ok"],
                        w_cont * m["diffuse"], zero3)
        a = a & ~unlit
        from_bsdf = s["fk"] == FROM_BSDF
        w = sel(a & from_bsdf, w_cont, w)
        a = a & torch.where(from_bsdf, s["cont_ok"], True)
        refr = (m["mtype"] == GLASS) | (m["mtype"] == ROUGH_T)

        # next-event estimation
        do_nee = a & ~refr
        lpos, lng, lem, lpdf = scene.sample_light(
            u(rng.LIGHT_PICK), u(rng.LIGHT_U), u(rng.LIGHT_V))
        lpos, lng, lpdf = sg(lpos), sg(lng), sg(lpdf)
        inside = dot(ns, wo) < 0.0
        sh_o = pos + sel(inside, -ns, ns) * EPSILON
        to_l = lpos + lng * EPSILON - sh_o
        dist = torch.sqrt(dot(to_l, to_l))
        sh_d = to_l * (1.0 / torch.clamp(dist, min=1e-20))[:, None]
        blocked = torch.zeros(k, dtype=torch.bool, device=dev)
        q = torch.nonzero(do_nee)[:, 0]
        if len(q):
            blocked[q] = scene.occluded(sh_o[q].detach(), sh_d[q].detach(),
                                        dist[q].detach())
        wi_l = lpos - pos
        r2 = dot(wi_l, wi_l)
        wi_l = normalize(wi_l, 1e-20)
        cos_p = dot(normalize(lng, 1e-20), -wi_l)
        live = do_nee & ~blocked & (dot(wi_l, lng) <= 0.0) & (cos_p > 0.0)
        pdf_m = sg(bsdf_pdf(m, wi_l, wo, ns, eta0))
        w_l = sg(mis(lpdf * r2 / torch.clamp(cos_p, min=1e-20), pdf_m))
        f_l = bsdf_eval(m, wi_l, wo, ng, ns, eta0)
        denom = r2 * lpdf
        kill = live & (denom < MIN_DIVISOR)
        live = live & ~kill
        scale = torch.where(live, w_l * dot(ng, wi_l).abs() * cos_p /
                            torch.clamp(denom, min=1e-20), 0.0)
        add = add + sel(live, w * lem * f_l * scale[:, None], zero3)
        a = a & ~kill

        # BSDF sampling
        wi, ok, tir = bsdf_sample(m, wo, ns, u(rng.BSDF_U0), u(rng.BSDF_U1),
                                  u(rng.BSDF_LOTTERY), eta0)
        wi = sg(wi)
        pdf = sg(bsdf_pdf(m, wi, wo, ns, eta0))
        wi_tir = normalize(reflect(wo, ns), 1e-20)
        flip = dot(wo, ng) < 0.0
        i_ns = sel(flip, -ns, ns)
        is_rt = m["mtype"] == ROUGH_T
        eta_pass = torch.where(flip & is_rt & tir, m["eta"], eta0)
        h_tir = normalize(wo + wi_tir, 1e-20)
        pdf_tir = torch.where(
            is_rt, ggx_d(h_tir, i_ns, m["rough"]) * dot(i_ns, h_tir).abs() /
            torch.clamp(4.0 * dot(wo, h_tir), min=1e-20), 1.0)
        rt = refr & tir
        wi = sel(rt, wi_tir, wi)
        pdf = torch.where(rt, sg(pdf_tir), pdf)
        eta_eval = torch.where(refr & tir, eta_pass, eta0)
        f = bsdf_eval(m, wi, wo, ng, ns, eta_eval, tir=rt)
        fail = a & ~refr & ~ok
        a = a & (refr | ok)
        tp_eff = s["tp"] if depth > opts["min_depth"] else one3(k)
        rr_p = sg(torch.clamp(tp_eff.max(-1).values, 0.0, 1.0)) \
            if opts["russian_roulette"] else torch.ones_like(pdf)
        survive = u(rng.RR) <= rr_p
        inv_pdf = torch.where(pdf >= MIN_DIVISOR,
                              1.0 / torch.clamp(pdf, min=1e-20), 0.0)
        base = f * (dot(ng, wi).abs() * inv_pdf)[:, None]
        em_ok = pdf >= MIN_DIVISOR
        cont_ok = survive & (pdf * rr_p >= MIN_DIVISOR)
        rr_inv = torch.where(rr_p > 0.0, 1.0 / torch.clamp(rr_p, min=1e-20),
                             0.0)
        nxt = a & torch.where(refr, em_ok, em_ok | cont_ok) & ~fail
        L = L.index_add(0, idx, add)
        upd = dict(
            o=pos + sel(dot(wi, ns) < 0.0, -ns, ns) * EPSILON, d=wi,
            w=sel(refr, w * base, w),
            tp=sel(refr, one3(k), tp_eff * (base * rr_inv[:, None])),
            w_em=w * base,
            fk=torch.where(refr, FROM_REFRACT, FROM_BSDF),
            prev_pdf=pdf, mirror1=(m["mtype"] == MIRROR) & (pdf == 1.0),
            rr_inv=rr_inv, cont_ok=cont_ok & a, em_ok=em_ok & a)
        st = {key: v.index_copy(0, idx, upd[key].to(v.dtype))
              for key, v in st.items()}
        alive = torch.zeros_like(alive).index_fill(0, idx[nxt], True)

    # the last pending BSDF-sampled ray: its emissive hit, nothing else
    idx = torch.nonzero(alive & (st["fk"] == FROM_BSDF))[:, 0]
    if len(idx):
        s = {k: v[idx] for k, v in st.items()}
        h = scene.nearest(s["o"], s["d"])
        pos, ng, ns, mat, area = scene.shade(s["o"], s["d"], h)
        gate = h["hit"] & scene.emissive(mat)
        L = L.index_add(0, idx, mis_emission(s, s["d"], h, ns, mat, area,
                                             gate))
    return torch.where(torch.isnan(L).any(-1, keepdim=True), 0.0, L)


def pixel_radiance_sum(scene: RefScene, cam_cfg: dict, width: int,
                       height: int, pixels, samples, seed: int, opts: dict,
                       chunk: int = 1 << 20):
    """Sum over the sample ids ``samples`` of the radiance of each pixel in
    ``pixels`` -> [len(pixels), 3] float64, traced in chunks of lanes."""
    dev = pixels.device
    lane = pixels.repeat(len(samples))
    smp = samples.repeat_interleave(len(pixels))
    out = torch.zeros((len(pixels), 3), dtype=torch.float64, device=dev)
    slot = torch.arange(len(pixels), device=dev).repeat(len(samples))
    for lo in range(0, len(lane), chunk):
        ln, sm = lane[lo:lo + chunk], smp[lo:lo + chunk]
        o, d = camera_rays(cam_cfg, width, height, ln, scene.dtype, dev)
        rad = trace(scene, o, d, ln, sm, seed, opts)
        out.index_add_(0, slot[lo:lo + chunk], rad.double())
    return out
