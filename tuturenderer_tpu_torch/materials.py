"""BSDF system: evaluate / sample / pdf over ray wavefronts.

The port of ``tuturenderer_tpu/materials.py`` (Material.hpp:62-439:
LAMBERTIAN, PERFECT_REFLECTIVE, PERFECT_REFRACTIVE, MICROFACET_R
Cook-Torrance GGX, MICROFACET_T rough dielectric, UNLIT) as branch-free
masked arithmetic: every lane computes each material branch present and one
select picks the active one.

Reference quirk kept as an option: ``sampleDirection`` for MICROFACET_R
uses a^2 = roughness^2 (Material.hpp:212-214) while its pdf uses
a^2 = roughness^4; ``ggx_sample_bug=True`` reproduces it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .scene.data import (LAMBERTIAN, MICROFACET_R, MICROFACET_T,
                         PERFECT_REFLECTIVE, PERFECT_REFRACTIVE, UNLIT,
                         SceneData)
from .utils.vec import (Vec3, lerp, local_to_world, reflect, refract,
                        where as vwhere)

PI = float(np.float32(math.pi))   # float32 pi, as the JAX package uses
FEQ = 1e-4   # FLOAT_EQUAL threshold (global.hpp:134-136)


class MatParams(NamedTuple):
    """Per-lane material parameters (post texture lookup)."""
    mtype: torch.Tensor
    diffuse: Vec3
    specular: Vec3
    emission: Vec3
    alpha: torch.Tensor
    eta: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor

    @property
    def emissive(self):
        """hasEmission (Material.hpp:54-56)."""
        e = self.emission
        return (e.x != 0.0) | (e.y != 0.0) | (e.z != 0.0)

    @property
    def is_refractive_kind(self):
        """Materials routed through calcForRefractive (PathTracing.hpp:152-154)."""
        return (self.mtype == PERFECT_REFRACTIVE) | (self.mtype == MICROFACET_T)


def gather_material(scene: SceneData, mat_idx) -> MatParams:
    """Per-lane rows of the material table (plain indexing)."""
    m = scene.materials
    i = torch.clamp(mat_idx, min=0).long()
    g3 = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
    return MatParams(
        mtype=m.mtype[i], diffuse=g3(m.diffuse), specular=g3(m.specular),
        emission=g3(m.emission), alpha=m.alpha[i], eta=m.eta[i],
        roughness=m.roughness[i], metallic=m.metallic[i])


# ---------------------------------------------------------------- helpers

def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick_v(cos_theta, f0: Vec3) -> Vec3:
    """Schlick with Vec3 F0 (global.hpp:236-239)."""
    p = _pow5(torch.clamp(1.0 - cos_theta, 0.0, 1.0))
    return f0 + (1.0 - f0) * p


def fresnel_ior(i: Vec3, n: Vec3, eta_i, eta_t):
    """Scalar Schlick from IORs with inside-flip (global.hpp:242-261)."""
    cos = i.dot(n).abs()
    f0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos, 0.0, 1.0))


def d_ndf(h: Vec3, n: Vec3, roughness):
    """Isotropic GGX NDF (global.hpp:311-324), incl. its clamps."""
    a = torch.clamp(roughness * roughness, min=1e-3)
    nh = n.dot(h)
    cos2 = nh * nh
    sin2 = 1.0 - cos2
    s = a * a * cos2 + sin2
    res = torch.where(s == 0.0, 1.0,
                      (a * a) / (PI * torch.clamp(s * s, min=1e-30)))
    return torch.where(nh < 0.0, 0.0, res)


def g_smith(wi: Vec3, wo: Vec3, n: Vec3, roughness, h: Vec3):
    """Smith shadow-masking (global.hpp:334-352)."""
    a = torch.clamp(roughness * roughness, min=1e-3)

    def g1(w: Vec3):
        cos = w.dot(n)
        cos2 = cos * cos
        cos2_safe = torch.where(cos2 > 0.0, cos2, 1.0)
        tan2 = torch.where(cos2 > 0.0, (1.0 - cos2) / cos2_safe, 1e30)
        sign_ok = (w.dot(h) * torch.sign(cos)) >= 0.0
        g = 2.0 / (1.0 + torch.sqrt(1.0 + a * a * torch.clamp(tan2, 0.0, 1e30)))
        return torch.where(sign_ok, g, 0.0) * torch.where(cos2 > 0.0, 1.0, 0.0)

    return g1(wi) * g1(wo)


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b) * (b != 0.0)


def _safe_div_v(v: Vec3, b) -> Vec3:
    ok = b != 0.0
    inv = 1.0 / torch.where(ok, b, 1.0)
    return v * (inv * ok.to(v.x.dtype))


# ---------------------------------------------------------------- evaluate

def bxdf_eval(p: MatParams, wi_in: Vec3, wo_in: Vec3, ng: Vec3, ns: Vec3,
              eta_scene, adjoint=False, tir=None, types=None) -> Vec3:
    """Material::BxDF (Material.hpp:62-191).

    wi: incident (toward light transport continuation), wo: view; both unit,
    pointing away from the surface. ``tir`` is a per-lane bool for the
    delta/rough-dielectric TIR path (may be None). ``types``: material
    types present in the scene; only those branches are computed."""
    has = (lambda t: True) if types is None else (lambda t: t in types)
    if tir is None:
        tir = torch.zeros_like(wi_in.x, dtype=torch.bool)
    wi, wo = (wo_in, wi_in) if adjoint else (wi_in, wo_in)

    # sidedness rejection for reflective kinds (Material.hpp:65-68) applies
    # to the ORIGINAL wi/wo order
    reject = ((wi_in.dot(ng) * wi_in.dot(ns) <= 0.0) |
              (wo_in.dot(ng) * wo_in.dot(ns) <= 0.0))

    correct = wi.dot(ns).abs() / torch.clamp(wi.dot(ng).abs(), min=1e-20)

    zero = torch.zeros_like(wi.x)
    zerov = Vec3(zero, zero, zero)

    branches = []

    # ---- LAMBERTIAN (Material.hpp:77-85)
    if has(LAMBERTIAN):
        lam = vwhere(wi.dot(ns) >= 0.0, p.diffuse * (correct / PI), zerov)
        branches.append((LAMBERTIAN, lam))

    # ---- MICROFACET_R (Material.hpp:87-108)
    if has(MICROFACET_R):
        h_r = (wi + wo).normalized(1e-20)
        f0 = lerp(Vec3(zero + 0.04, zero + 0.04, zero + 0.04), p.diffuse,
                  p.metallic)
        f_r = fresnel_schlick_v(h_r.dot(wi), f0)
        d_r = d_ndf(h_r, ns, p.roughness)
        g_r = g_smith(wi, wo, ns, p.roughness, h_r)
        denom_r = 4.0 * wi.dot(ns) * wo.dot(ns)
        spec = _safe_div_v(f_r * (g_r * d_r), denom_r)
        micro_r = (spec + (1.0 - f_r) * p.diffuse * (1.0 / PI)) * correct
        branches.append((MICROFACET_R, micro_r))

    # ---- MICROFACET_T (Material.hpp:110-149)
    if has(MICROFACET_T):
        flip_t = wo.dot(ns) < 0.0
        n_t = vwhere(flip_t, -ns, ns)
        eta_i_t = torch.where(flip_t, p.eta, eta_scene)
        eta_t_t = torch.where(flip_t, eta_scene, p.eta)
        is_refl = wi.dot(n_t) >= 0.0
        #   reflection branch
        h_tr = (wo + wi).normalized(1e-20)
        f_tr = torch.where(tir, 1.0, fresnel_ior(wi, h_tr, eta_i_t, eta_t_t))
        d_tr = d_ndf(h_tr, n_t, p.roughness)
        g_tr = g_smith(wi, wo, n_t, p.roughness, h_tr)
        denom_tr = 4.0 * wi.dot(n_t) * wo.dot(n_t)
        val_tr = _safe_div(f_tr * g_tr * d_tr, denom_tr)
        #   refraction branch
        h_tt = -(wo * eta_i_t + wi * eta_t_t).normalized(1e-20)
        h_tt = vwhere(h_tt.dot(n_t) < 0.0, -h_tt, h_tt)
        cos_ih = wi.dot(h_tt)
        cos_oh = wo.dot(h_tt)
        cos_in = wi.dot(n_t)
        cos_on = wo.dot(n_t)
        f_tt = fresnel_ior(wi, h_tt, eta_i_t, eta_t_t)
        d_tt = d_ndf(h_tt, n_t, p.roughness)
        g_tt = g_smith(wi, wo, n_t, p.roughness, h_tt)
        numer = cos_ih.abs() * cos_oh.abs() * eta_t_t * eta_t_t * \
            (1.0 - f_tt) * g_tt * d_tt
        denom_tt = cos_in.abs() * cos_on.abs() * \
            (eta_i_t * cos_ih + eta_t_t * cos_oh) ** 2
        val_tt = _safe_div(numer, denom_tt)
        micro_t_s = torch.where(is_refl, val_tr, val_tt) * correct
        branches.append((MICROFACET_T, Vec3(micro_t_s, micro_t_s, micro_t_s)))

    # ---- PERFECT_REFLECTIVE (Material.hpp:151-157)
    if has(PERFECT_REFLECTIVE):
        aligned = ((wi + wo).normalized(1e-20).dot(ns) - 1.0).abs() < FEQ
        mirror_s = torch.where(
            aligned, correct / torch.clamp(ns.dot(wi).abs(), min=1e-20), 0.0)
        branches.append((PERFECT_REFLECTIVE,
                         Vec3(mirror_s, mirror_s, mirror_s)))

    # ---- PERFECT_REFRACTIVE (Material.hpp:159-186)
    if has(PERFECT_REFRACTIVE):
        flip_p = wo.dot(ns) < 0.0
        n_p = vwhere(flip_p, -ns, ns)
        eta_i_p = torch.where(flip_p, p.eta, eta_scene)
        eta_t_p = torch.where(flip_p, eta_scene, p.eta)
        f_p = fresnel_ior(wi, n_p, eta_i_p, eta_t_p)
        ref_dir = reflect(wo, ns).normalized(1e-20)
        trans_dir, _ = refract(wo, n_p, eta_i_p, eta_t_p)
        trans_dir = trans_dir.normalized(1e-20)
        n_p2 = vwhere(n_p.dot(wi) < 0.0, -n_p, n_p)
        inv_cos = 1.0 / torch.where(n_p2.dot(wi) == 0.0, 1e-20, n_p2.dot(wi))
        is_ref = (wi.dot(ref_dir) - 1.0).abs() < FEQ
        is_trn = (wi.dot(trans_dir) - 1.0).abs() < FEQ
        pr_s = torch.where(
            tir, inv_cos * correct,
            torch.where(is_ref, f_p * inv_cos * correct,
                        torch.where(is_trn, (1.0 - f_p) * inv_cos * correct,
                                    0.0)))
        branches.append((PERFECT_REFRACTIVE, Vec3(pr_s, pr_s, pr_s)))

    # ---- select by type
    t = p.mtype
    out = zerov
    for ty, val in reversed(branches):
        out = vwhere(t == ty, val, out)
    # sidedness rejection only for non-transmissive kinds
    transmissive = (t == MICROFACET_T) | (t == PERFECT_REFRACTIVE)
    return vwhere(reject & ~transmissive, zerov, out)


# ---------------------------------------------------------------- sample

class SampleResult(NamedTuple):
    wi: Vec3
    success: torch.Tensor   # bool
    tir: torch.Tensor       # bool "special event"


def _ggx_half_vector(n: Vec3, roughness, r0, r1, a2):
    phi = 2.0 * PI * r1
    cos_t = torch.sqrt(torch.clamp((1.0 - r0) / (r0 * (a2 - 1.0) + 1.0),
                                   0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    return local_to_world(n, local)


def bxdf_sample(p: MatParams, wo: Vec3, n: Vec3, r0, r1, lottery, eta_scene,
                ggx_sample_bug: bool = False, types=None) -> SampleResult:
    """Material::sampleDirection (Material.hpp:200-343)."""
    has = (lambda t: True) if types is None else (lambda t: t in types)
    won = wo.dot(n)

    wi_branches = []
    r2 = p.roughness * p.roughness

    if has(MICROFACET_T) or has(PERFECT_REFRACTIVE):
        flip = won < 0.0
        n_t = vwhere(flip, -n, n)
        eta_i = torch.where(flip, p.eta, eta_scene)
        eta_t = torch.where(flip, eta_scene, p.eta)

    # ---- MICROFACET_R (Material.hpp:203-229)
    if has(MICROFACET_R):
        a2_r = r2 * torch.clamp(p.alpha, min=1e-3) if ggx_sample_bug else \
            torch.clamp(r2, min=1e-3) ** 2
        h_r = _ggx_half_vector(n, p.roughness, r0, r1, a2_r)
        wi_mr = reflect(wo, h_r).normalized(1e-20)
        ok_mr = (won > 0.0) & (wi_mr.dot(n) > 0.0)
        wi_branches.append((MICROFACET_R, wi_mr))

    # ---- MICROFACET_T (Material.hpp:231-267)
    if has(MICROFACET_T):
        a_t = torch.clamp(r2, min=1e-3)
        a2_t = a_t * a_t
        h_t = _ggx_half_vector(n_t, p.roughness, r0, r1, a2_t)
        refr_t, tir_t = refract(wo, h_t, eta_i, eta_t)
        f_t = fresnel_ior(wo, h_t, eta_i, eta_t)
        wi_mt = vwhere(lottery < f_t, reflect(wo, h_t), refr_t)
        wi_branches.append((MICROFACET_T, wi_mt))

    # ---- LAMBERTIAN cosine-weighted (Material.hpp:270-306)
    cos_l = torch.sqrt(torch.clamp(r0, min=1e-12))
    sin_l = torch.sqrt(torch.clamp(1.0 - r0, min=1e-12))
    phi_l = 2.0 * PI * r1
    wi_lam = local_to_world(n, Vec3(torch.cos(phi_l) * sin_l,
                                    torch.sin(phi_l) * sin_l, cos_l))
    ok_lam = (won > 0.0) & (wi_lam.dot(n) >= 0.0)

    # ---- PERFECT_REFLECTIVE (Material.hpp:309-313)
    if has(PERFECT_REFLECTIVE):
        wi_branches.append((PERFECT_REFLECTIVE, reflect(wo, n)))

    # ---- PERFECT_REFRACTIVE (Material.hpp:314-335)
    if has(PERFECT_REFRACTIVE):
        refr_p, tir_p = refract(wo, n_t, eta_i, eta_t)
        f_p = fresnel_ior(wo, n_t, eta_i, eta_t)
        wi_pr = vwhere(lottery < f_p, reflect(wo, n_t), refr_p)
        wi_branches.append((PERFECT_REFRACTIVE, wi_pr))

    t = p.mtype
    wi = wi_lam
    for ty, val in reversed(wi_branches):
        wi = vwhere(t == ty, val, wi)
    success = torch.where(t == LAMBERTIAN, ok_lam, t != UNLIT)
    if has(MICROFACET_R):
        success = torch.where(t == MICROFACET_R, ok_mr, success)
    tir = torch.zeros_like(wo.x, dtype=torch.bool)
    if has(MICROFACET_T):
        tir = torch.where(t == MICROFACET_T, tir_t, tir)
    if has(PERFECT_REFRACTIVE):
        tir = torch.where(t == PERFECT_REFRACTIVE, tir_p, tir)
    wi = vwhere(tir, wi_lam * 0.0, wi)  # reference returns zero vec on TIR
    return SampleResult(wi=wi.normalized(1e-20), success=success, tir=tir)


# ---------------------------------------------------------------- pdf

def bxdf_pdf(p: MatParams, wi: Vec3, wo: Vec3, n: Vec3, eta_scene,
             eta_mat=None, types=None):
    """Material::pdf (Material.hpp:350-439); solid-angle measure."""
    has = (lambda t: True) if types is None else (lambda t: t in types)
    if eta_mat is None:
        eta_mat = p.eta
    zero = torch.zeros_like(wi.x)
    branches = []

    # LAMBERTIAN (Material.hpp:353-361)
    if has(LAMBERTIAN):
        pdf_lam = torch.where(wi.dot(n) > 0.0,
                              torch.clamp(wi.dot(n), min=0.0) / PI, 0.0)
        branches.append((LAMBERTIAN, pdf_lam))

    if has(MICROFACET_R) or has(MICROFACET_T) or has(PERFECT_REFLECTIVE):
        h = (wo + wi).normalized(1e-20)

    # MICROFACET_R (Material.hpp:362-373)
    if has(MICROFACET_R):
        cos_r = torch.clamp(n.dot(h), min=0.0)
        branches.append((MICROFACET_R, _safe_div(
            d_ndf(h, n, p.roughness) * cos_r, 4.0 * wo.dot(h))))

    if has(MICROFACET_T) or has(PERFECT_REFRACTIVE):
        flip = wo.dot(n) < 0.0
        n_t = vwhere(flip, -n, n)
        eta_i = torch.where(flip, eta_mat, eta_scene)
        eta_t = torch.where(flip, eta_scene, eta_mat)

    # MICROFACET_T (Material.hpp:374-405)
    if has(MICROFACET_T):
        f = fresnel_ior(wo, n_t, eta_i, eta_t)
        #   reflection branch
        cos_tr = n_t.dot(h).abs()
        pdf_mt_r = _safe_div(f * d_ndf(h, n_t, p.roughness) * cos_tr,
                             4.0 * wo.dot(h))
        #   refraction branch
        h_tt = -(wo * eta_i + wi * eta_t).normalized(1e-20)
        cos_tt = n_t.dot(h_tt)
        h_tt = vwhere(cos_tt < 0.0, -h_tt, h_tt)
        cos_tt = cos_tt.abs()
        dsq = eta_i * wi.dot(h_tt) + eta_t * wo.dot(h_tt)
        jac = _safe_div(eta_t * eta_t * wo.dot(h_tt).abs(), dsq * dsq)
        pdf_mt_t = (1.0 - f) * d_ndf(h_tt, n_t, p.roughness) * cos_tt * jac
        branches.append((MICROFACET_T,
                         torch.where(wi.dot(n_t) >= 0.0, pdf_mt_r, pdf_mt_t)))

    # PERFECT_REFLECTIVE (Material.hpp:407-412)
    if has(PERFECT_REFLECTIVE):
        branches.append((PERFECT_REFLECTIVE,
                         torch.where((h.dot(n) - 1.0).abs() < FEQ, 1.0, 0.0)))

    # PERFECT_REFRACTIVE (Material.hpp:414-433)
    if has(PERFECT_REFRACTIVE):
        ref_dir = reflect(wo, n).normalized(1e-20)
        trans_dir, _ = refract(wo, n_t, eta_i, eta_t)
        trans_dir = trans_dir.normalized(1e-20)
        f_p = fresnel_ior(wo, n_t, eta_i, eta_t)
        branches.append((PERFECT_REFRACTIVE, torch.where(
            (wi.dot(ref_dir) - 1.0).abs() < FEQ, f_p,
            torch.where((wi.dot(trans_dir) - 1.0).abs() < FEQ, 1.0 - f_p,
                        0.0))))

    t = p.mtype
    out = zero + 1.0   # default case (Material.hpp:435-437)
    for ty, val in reversed(branches):
        out = torch.where(t == ty, val, out)
    return out


def mis_power_weight(pdf, other_pdf):
    """Power heuristic (global.hpp:374-380)."""
    s = pdf + other_pdf
    return _safe_div(pdf * pdf, s * s)
