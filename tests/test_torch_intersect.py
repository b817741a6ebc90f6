"""Dense intersection of the PyTorch port against the JAX package's Pallas
Woop kernels (``ops/pallas/intersect.py::_kernel_woop`` and
``::_kernel_woop_anyhit``, run in interpret mode on the CPU).

On the CPU the port's ``tri_intersect`` / ``tri_occluded`` run their plain
PyTorch versions, which the CUDA kernels match bit for bit on the card
(chip_smoke.py). Tolerances:

- hit/miss agreement >= 99.9 % (a ray that grazes an edge may round to
  either side; in these sets all rays agree);
- t within rtol 1e-5 where both hit (the same float32 expression, so in
  practice equal);
- idx equal and bu/bv within atol 1e-5 where t is unique: for T <= 64 the
  Pallas kernel interleaves two best-hit chains, so an exact t tie may keep
  the odd index there while the port keeps the lowest.
- shading attributes within rtol 1e-5 / atol 1e-5; sphere u/v go through
  acos/atan2, whose float32 results differ between XLA and PyTorch by a few
  ulps, steepest near the poles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (flatten, jax_dense_pallas_interpret,
                             unique_nearest)
from tuturenderer_tpu.ops import intersect as JI
from tuturenderer_tpu.ops.pallas.intersect import (pallas_tri_intersect,
                                                   pallas_tri_occluded)
from tuturenderer_tpu.scene.data import SceneBuilder as JBuilder
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.utils.vec import Vec3


def _soup(seed=3, n_tris=48, n_rays=256):
    r = np.random.RandomState(seed)
    b = JBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    b.add_triangles(
        (centers[:, None, :] + 0.6 * r.randn(n_tris, 3, 3)).astype(np.float32),
        None, None, m)
    o = (r.randn(n_rays, 3) * 3.0).astype(np.float32)
    # aim at the triangles so most rays hit, many near an edge
    aim = centers[r.randint(0, n_tris, n_rays)] + 0.4 * r.randn(n_rays, 3)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b.build(), o, d


def _box(seed=5, n_bounce=256):
    """simple_box with its 24x20 camera rays plus random bounce rays from
    inside the box."""
    from tuturenderer_tpu.camera import primary_ray
    scene, cam = j_simple_box(24, 20)
    pix = jnp.arange(24 * 20, dtype=jnp.int32)
    o, d, _ = primary_ray(cam, pix % 24, pix // 24)
    r = np.random.RandomState(seed)
    ob = (r.rand(n_bounce, 3) * 1.98 - 0.99).astype(np.float32)
    db = r.randn(n_bounce, 3).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    o = np.concatenate([np.stack([np.asarray(c) for c in o], 1), ob])
    d = np.concatenate([np.stack([np.asarray(c) for c in d], 1), db])
    return scene, o.astype(np.float32), d.astype(np.float32)


CASES = {"soup48": _soup, "simple_box": _box}


def _jvec(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


def _tvec(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3)])


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jscene, o, d = CASES[request.param]()
    scene = scene_from_numpy(flatten(jscene), device="cpu")
    return jscene, scene, o, d


def test_nearest_matches_pallas_interpret(case):
    jscene, scene, o, d = case
    jt, jidx, jbu, jbv = map(np.asarray, pallas_tri_intersect(
        jscene, _jvec(o), _jvec(d), interpret=True))
    table = K.pack_triangles_woop(scene)
    t, idx, bu, bv = (a.numpy() for a in K.tri_intersect(
        table, *_tvec(o), *_tvec(d)))
    assert idx.dtype == np.int32
    hit, jhit = idx >= 0, jidx >= 0
    assert (hit == jhit).mean() >= 0.999
    assert hit.mean() > 0.3
    both = hit & jhit
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    uniq = both & unique_nearest(table, o, d)
    np.testing.assert_array_equal(idx[uniq], jidx[uniq])
    np.testing.assert_allclose(bu[uniq], jbu[uniq], atol=1e-5)
    np.testing.assert_allclose(bv[uniq], jbv[uniq], atol=1e-5)
    assert (t[~hit] == np.float32(3.4e38)).all()


def test_anyhit_matches_pallas_interpret(case):
    jscene, scene, o, d = case
    jt, jidx, _, _ = map(np.asarray, pallas_tri_intersect(
        jscene, _jvec(o), _jvec(d), interpret=True))
    t_ref = np.where(jidx >= 0, jt, 1.0).astype(np.float32)
    table = K.pack_triangles_woop(scene)
    for scale, off in ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                       (1.0, 3e-4), (1.0, 0.3)):
        dist = (t_ref * scale + off).astype(np.float32)
        want = np.asarray(pallas_tri_occluded(jscene, _jvec(o), _jvec(d),
                                              jnp.asarray(dist),
                                              interpret=True))
        got = K.tri_occluded(table, *_tvec(o), *_tvec(d),
                             torch.from_numpy(dist)).numpy()
        assert got.dtype == np.bool_
        assert (got == want).mean() >= 0.999, (scale, off)


def test_anyhit_endpoint_guard():
    """dist exactly at the hit distance, or within 1e-4 of it, is not
    occluded (BVH.hpp:184); as tests/test_pallas.py checks the JAX kernel."""
    b = JBuilder()
    m = b.add_material()
    b.add_triangles(
        np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32),
        None, None, m)
    scene = scene_from_numpy(flatten(b.build()), device="cpu")
    z = torch.zeros(4)
    dist = torch.tensor([2.0, 1.0, 0.5, 1.0 + 5e-5])
    got = K.tri_occluded(K.pack_triangles_woop(scene), z, z, z, z, z,
                         torch.ones(4), dist)
    assert got.tolist() == [True, False, False, False]


def test_intersect_core_and_shade_hit_match_jax(case):
    """The whole dense query, spheres included, per ray."""
    jscene, scene, o, d = case
    with jax_dense_pallas_interpret():
        jcore = JI.intersect_core(jscene, _jvec(o), _jvec(d))
        jrec = JI.shade_hit(jscene, _jvec(o), _jvec(d), jcore)
    core = TI.intersect_core(scene, _tvec(o), _tvec(d))
    rec = TI.shade_hit(scene, _tvec(o), _tvec(d), core)
    hit, jhit = core.hit.numpy(), np.asarray(jcore.hit)
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    np.testing.assert_allclose(core.t.numpy()[both],
                               np.asarray(jcore.t)[both], rtol=1e-5)
    uniq = both & unique_nearest(K.pack_triangles_woop(scene), o, d)
    for f in ("kind", "idx"):
        got = getattr(core, f).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got[uniq],
                                      np.asarray(getattr(jcore, f))[uniq])
    np.testing.assert_array_equal(rec.mat.numpy()[uniq],
                                  np.asarray(jrec.mat)[uniq])
    np.testing.assert_array_equal(rec.area.numpy()[uniq],
                                  np.asarray(jrec.area)[uniq])
    for f in ("pos", "ng", "ns"):
        for c in range(3):
            np.testing.assert_allclose(
                getattr(rec, f)[c].numpy()[uniq],
                np.asarray(getattr(jrec, f)[c])[uniq], rtol=1e-5, atol=1e-5,
                err_msg=f)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(rec, f).numpy()[uniq],
                                   np.asarray(getattr(jrec, f))[uniq],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_occluded_matches_jax(case):
    """Shadow query with spheres and a dead-lane mask."""
    jscene, scene, o, d = case
    r = np.random.RandomState(11)
    dist = (r.rand(o.shape[0]) * 3.0).astype(np.float32)
    mask = r.rand(o.shape[0]) > 0.2
    with jax_dense_pallas_interpret():
        want = np.asarray(JI.occluded(jscene, _jvec(o), _jvec(d),
                                      jnp.asarray(dist),
                                      mask=jnp.asarray(mask)))
    got = TI.occluded(scene, _tvec(o), _tvec(d), torch.from_numpy(dist),
                      mask=torch.from_numpy(mask)).numpy()
    assert (got == want).mean() >= 0.999
    assert not got[~mask].any()


def test_dead_lanes_miss(case):
    _, scene, o, d = case
    mask = torch.zeros(o.shape[0], dtype=torch.bool)
    core = TI.intersect_core(scene, _tvec(o), _tvec(d), mask=mask)
    assert (core.idx == -1).all()


def _good_args():
    table = torch.zeros(13 * 2)
    return table, [torch.zeros(8) for _ in range(6)]


@pytest.mark.parametrize("bad", [
    "float64", "2-D", "non-contiguous", "lengths", "table-length",
    "too-many-triangles"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    table, rays = _good_args()
    if bad == "float64":
        rays[0] = rays[0].double()
    elif bad == "2-D":
        rays[1] = rays[1].reshape(2, 4)
    elif bad == "non-contiguous":
        rays[2] = torch.zeros(16)[::2]
    elif bad == "lengths":
        rays[3] = torch.zeros(9)
    elif bad == "table-length":
        table = torch.zeros(27)
    else:
        table = torch.zeros(13 * 4096)
    with pytest.raises(ValueError):
        K.tri_intersect(table, *rays)
    with pytest.raises(ValueError):
        K.tri_occluded(table, *rays, torch.zeros(rays[0].shape[0]))
