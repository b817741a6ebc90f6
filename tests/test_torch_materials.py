"""BSDFs, light sampling and textures of the PyTorch port against the JAX
package, per lane on the same seeded inputs.

Tolerance: rtol 1e-5 / atol 1e-6 unless stated. Wider, with the reason:

- sampled directions (bxdf_sample) and sphere light points go through
  sin/cos, which XLA and PyTorch evaluate with different float32
  polynomials (a few ulps); rtol 1e-5 / atol 1e-5;
- GGX values (MICROFACET_R/T): near the specular peak the NDF's
  sin^2 = 1 - (h.n)^2 cancels, and XLA's rsqrt (up to 2 ulps from 1/sqrt)
  and PyTorch's give half vectors an ulp apart, which that cancellation
  amplifies without bound as h approaches n (a few % on low-roughness
  lanes). So >= 98 % of lanes within rtol 2e-4, and the rest within
  rtol 0.25 (they agree in sign and scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten
from tuturenderer_tpu import materials as JM
from tuturenderer_tpu.integrators.path import apply_textures as j_apply
from tuturenderer_tpu.ops import intersect as JI
from tuturenderer_tpu.ops import lights as JL
from tuturenderer_tpu.scene import data as jdata
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch import materials as TM
from tuturenderer_tpu_torch.integrators.path import apply_textures as t_apply
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops import lights as TL
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.utils.vec import Vec3

N = 2048
TYPES = [jdata.LAMBERTIAN, jdata.PERFECT_REFLECTIVE, jdata.PERFECT_REFRACTIVE,
         jdata.MICROFACET_R, jdata.MICROFACET_T, jdata.UNLIT]
GGX = (jdata.MICROFACET_R, jdata.MICROFACET_T)


def _unit(r, n):
    v = r.randn(n, 3).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _both(a):
    """numpy [N] or [N,3] -> (jax, torch) in the packages' forms."""
    a = np.ascontiguousarray(a)
    if a.ndim == 2:
        return (JVec3(*[jnp.asarray(a[:, i]) for i in range(3)]),
                Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, i]))
                       for i in range(3)]))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], axis=1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _close_bsdf(got, want, mtype):
    if mtype not in GGX:
        return _close(got, want)
    got, want = _np(got), _np(want)
    ok = np.isclose(got, want, rtol=2e-4, atol=1e-6)
    assert ok.mean() >= 0.98, ok.mean()
    np.testing.assert_allclose(got, want, rtol=0.25, atol=1e-6)


def _inputs(mtype, seed):
    r = np.random.RandomState(seed)
    cols = dict(
        mtype=np.full(N, mtype, np.int32),
        diffuse=r.rand(N, 3).astype(np.float32),
        specular=r.rand(N, 3).astype(np.float32),
        emission=np.zeros((N, 3), np.float32),
        alpha=r.rand(N).astype(np.float32),
        eta=(1.1 + r.rand(N)).astype(np.float32),
        roughness=(0.05 + 0.95 * r.rand(N)).astype(np.float32),
        metallic=r.rand(N).astype(np.float32))
    jp = JM.MatParams(**{k: _both(v)[0] for k, v in cols.items()})
    tp = TM.MatParams(**{k: _both(v)[1] for k, v in cols.items()})
    ns = _unit(r, N)
    ng = ns + 0.3 * _unit(r, N)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    wo = _unit(r, N)
    wo[: N // 2] *= np.sign((wo[: N // 2] * ns[: N // 2]).sum(1))[:, None]
    u = [r.rand(N).astype(np.float32) for _ in range(3)]
    return r, jp, tp, ns, ng, wo, u


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("mtype", TYPES)
def test_bxdf_sample_matches_jax(mtype, bug):
    _, jp, tp, ns, _, wo, (r0, r1, lot) = _inputs(mtype, 1 + mtype)
    eta = 1.0
    want = JM.bxdf_sample(jp, _both(wo)[0], _both(ns)[0], *map(jnp.asarray,
                          (r0, r1, lot)), jnp.float32(eta), bug)
    got = TM.bxdf_sample(tp, _both(wo)[1], _both(ns)[1], *map(
        torch.from_numpy, (r0, r1, lot)), torch.tensor(eta), bug)
    np.testing.assert_array_equal(_np(got.success), _np(want.success))
    np.testing.assert_array_equal(_np(got.tir), _np(want.tir))
    _close(got.wi, want.wi, atol=1e-5, msg="wi")


def _eval_dirs(mtype, seed):
    """Half the lanes take wi from the JAX sampler (so the delta lobes are
    hit), half a random direction."""
    r, jp, tp, ns, ng, wo, (r0, r1, lot) = _inputs(mtype, seed)
    s = JM.bxdf_sample(jp, _both(wo)[0], _both(ns)[0], jnp.asarray(r0),
                       jnp.asarray(r1), jnp.asarray(lot), jnp.float32(1.0))
    wi = _np(s.wi).astype(np.float32)
    wi[N // 2:] = _unit(r, N - N // 2)
    tir = np.asarray(s.tir) | (r.rand(N) < 0.1)
    return jp, tp, ns, ng, wo, wi, tir


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("mtype", TYPES)
def test_bxdf_eval_matches_jax(mtype, adjoint):
    jp, tp, ns, ng, wo, wi, tir = _eval_dirs(mtype, 20 + mtype)
    want = JM.bxdf_eval(jp, _both(wi)[0], _both(wo)[0], _both(ng)[0],
                        _both(ns)[0], jnp.float32(1.0), adjoint=adjoint,
                        tir=jnp.asarray(tir))
    got = TM.bxdf_eval(tp, _both(wi)[1], _both(wo)[1], _both(ng)[1],
                       _both(ns)[1], torch.tensor(1.0), adjoint=adjoint,
                       tir=torch.from_numpy(tir))
    _close_bsdf(got, want, mtype)
    if mtype != jdata.UNLIT:
        assert (_np(want) != 0).any()


@pytest.mark.parametrize("mtype", TYPES)
def test_bxdf_pdf_matches_jax(mtype):
    jp, tp, ns, _, wo, wi, _ = _eval_dirs(mtype, 40 + mtype)
    want = JM.bxdf_pdf(jp, _both(wi)[0], _both(wo)[0], _both(ns)[0],
                       jnp.float32(1.0), types=tuple(TYPES))
    got = TM.bxdf_pdf(tp, _both(wi)[1], _both(wo)[1], _both(ns)[1],
                      torch.tensor(1.0), types=tuple(TYPES))
    _close_bsdf(got, want, mtype)


def test_mis_power_weight_matches_jax():
    r = np.random.RandomState(2)
    a = (r.rand(N) * 5).astype(np.float32)
    b = (r.rand(N) * 5).astype(np.float32)
    a[:10] = 0.0
    b[:5] = 0.0
    _close(TM.mis_power_weight(*map(torch.from_numpy, (a, b))),
           JM.mis_power_weight(*map(jnp.asarray, (a, b))))


def _textured_scene(mod):
    r = np.random.RandomState(4)
    b = mod.SceneBuilder(bkgcolor=(0.1, 0.2, 0.3), eta=1.2)
    dm = b.add_texture("diffuse", "d", r.rand(5, 7, 3))
    nm = b.add_texture("normal", "n", r.rand(4, 4, 3) * 2 - 1)
    rm = b.add_texture("roughness", "r", r.rand(3, 6, 3))
    mm = b.add_texture("metallic", "m", r.rand(6, 3, 3))
    tex = b.add_material(mod.MICROFACET_R, diffuse=(0.5, 0.4, 0.3),
                         roughness=0.3, metallic=0.2, diffuse_map=dm,
                         normal_map=nm, roughness_map=rm, metallic_map=mm)
    half = b.add_material(mod.LAMBERTIAN, diffuse=(0.7, 0.7, 0.7),
                          normal_map=nm)
    light = b.add_material(mod.LAMBERTIAN, emission=(5.0, 4.0, 3.0))
    verts = r.randn(10, 3, 3).astype(np.float32)
    uvs = (r.rand(10, 3, 2) * 3 - 1).astype(np.float32)
    b.add_triangles(verts[:6], None, uvs[:6], tex)
    b.add_triangles(verts[6:8], None, uvs[6:8], half)
    b.add_triangles(verts[8:], None, None, light)
    b.add_sphere((0.0, 0.5, 2.0), 0.5, tex)
    b.add_sphere((1.0, -0.5, 2.0), 0.3, light)
    return b.build()


def test_apply_textures_matches_jax():
    jscene = _textured_scene(jdata)
    scene = scene_from_numpy(flatten(jscene))
    r = np.random.RandomState(8)
    kind = r.randint(0, 2, N).astype(np.int32)
    idx = np.where(kind == 0, r.randint(0, 10, N),
                   r.randint(0, 2, N)).astype(np.int32)
    ng = _unit(r, N)
    ns = _unit(r, N)
    ns = np.where((ns * ng).sum(1, keepdims=True) < 0, -ns, ns)
    f = lambda a: a.astype(np.float32)
    cols = dict(t=f(r.rand(N)), hit=np.ones(N, bool), pos=f(r.randn(N, 3)),
                ng=ng, ns=ns, u=f(r.rand(N) * 4 - 2), v=f(r.rand(N) * 4 - 2),
                mat=r.randint(0, 3, N).astype(np.int32), kind=kind, idx=idx,
                area=f(r.rand(N)))
    jhit = JI.HitRecord(**{k: _both(v)[0] for k, v in cols.items()})
    thit = TI.HitRecord(**{k: _both(v)[1] for k, v in cols.items()})
    jparams, jns = j_apply(jscene, jhit, JM.gather_material(jscene, jhit.mat))
    tparams, tns = t_apply(scene, thit, TM.gather_material(scene, thit.mat))
    for fld in ("mtype", "diffuse", "specular", "roughness", "metallic",
                "eta", "alpha"):
        _close(getattr(tparams, fld), getattr(jparams, fld), msg=fld)
    _close(tns, jns, atol=1e-5, msg="ns")
    assert (_np(tns) != ns).any()          # some normals were mapped


@pytest.mark.parametrize("pick,tri", [(False, False), (True, True)])
@pytest.mark.parametrize("which", ["simple_box", "textured"])
def test_sample_light_matches_jax(which, pick, tri):
    jscene = j_simple_box(8, 8)[0] if which == "simple_box" \
        else _textured_scene(jdata)
    scene = scene_from_numpy(flatten(jscene))
    r = np.random.RandomState(6)
    u = [r.rand(N).astype(np.float32) for _ in range(3)]
    want = JL.sample_light(jscene, *map(jnp.asarray, u), pick, tri)
    got = TL.sample_light(scene, *map(torch.from_numpy, u), pick, tri)
    for fld in ("pos", "ng"):
        _close(getattr(got, fld), getattr(want, fld), atol=1e-5, msg=fld)
    _close(got.emission, want.emission, msg="emission")
    _close(got.pdf_area, want.pdf_area, msg="pdf_area")
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))


@pytest.mark.parametrize("with_area", [False, True])
def test_light_pdf_of_hit_matches_jax(with_area):
    jscene = _textured_scene(jdata)
    scene = scene_from_numpy(flatten(jscene))
    r = np.random.RandomState(9)
    kind = r.randint(0, 2, N).astype(np.int32)
    idx = np.where(kind == 0, r.randint(-1, 10, N),
                   r.randint(0, 2, N)).astype(np.int32)
    mat = r.randint(0, 3, N).astype(np.int32)
    area = r.rand(N).astype(np.float32) if with_area else None
    jarg = [_both(a)[0] for a in (kind, idx, mat)]
    targ = [_both(a)[1] for a in (kind, idx, mat)]
    want = JL.light_pdf_of_hit(jscene, *jarg,
                               None if area is None else jnp.asarray(area))
    got = TL.light_pdf_of_hit(scene, *targ, None if area is None
                              else torch.from_numpy(area))
    _close(got, want)
    assert (_np(want) > 0).any()


def test_sample_cosine_dir_matches_jax():
    r = np.random.RandomState(10)
    n = _unit(r, N)
    u = [r.rand(N).astype(np.float32) for _ in range(2)]
    jd, jpdf, jok = JL.sample_cosine_dir(_both(n)[0], *map(jnp.asarray, u))
    td, tpdf, tok = TL.sample_cosine_dir(_both(n)[1], *map(torch.from_numpy, u))
    _close(td, jd, atol=1e-5)
    _close(tpdf, jpdf, atol=1e-5)
    np.testing.assert_array_equal(_np(tok), _np(jok))
