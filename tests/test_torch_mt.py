"""The Moller-Trumbore (MT) form of the port's dense intersection against
the JAX package: ``pack_triangles``, the plain versions of K3/K4 against
the Pallas kernels ``ops/pallas/intersect.py::_kernel`` and
``::_kernel_anyhit`` in interpret mode (``PALLAS_IMPL = "mt"``, set and
restored here), and the port's MT route through ``intersect_core`` /
``occluded`` against the JAX package's XLA MT route (its CPU route).

On the CPU the port's ``tri_intersect_mt`` / ``tri_occluded_mt`` run their
plain versions, which the CUDA kernels match bit for bit on the card
(chip_smoke.py). Tolerances:

- the MT table: v0, e1 and e2 are bit-equal (one float32 subtraction
  each); n_hat within 4 ulp or 1e-7 absolute (|n| goes through a sqrt and
  a reciprocal that XLA and PyTorch may round differently, and a cross
  product that cancels leaves components near 0);
- hit/miss agreement >= 99.9 % (a ray that grazes an edge may round to
  either side; in these sets every ray agrees);
- t within rtol 1e-5 where both hit; idx equal and bu/bv within atol 1e-5
  where t is unique (the MT kernel loops sequentially, so an exact tie
  keeps the lowest index on both sides, but the comparison does not rely
  on it);
- shading attributes within rtol 1e-5 / atol 1e-5, as for the Woop form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten
from tuturenderer_tpu.ops import intersect as JI
from tuturenderer_tpu.ops.pallas import intersect as JP
from tuturenderer_tpu.scene.data import SceneBuilder as JBuilder
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.utils.vec import Vec3


def _soup(n_tris, seed=3, n_rays=256):
    r = np.random.RandomState(seed)
    b = JBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    b.add_triangles(
        (centers[:, None, :] + 0.6 * r.randn(n_tris, 3, 3)).astype(np.float32),
        None, None, m)
    o = (r.randn(n_rays, 3) * 3.0).astype(np.float32)
    aim = centers[r.randint(0, n_tris, n_rays)] + 0.4 * r.randn(n_rays, 3)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return b.build(), o, d


def _box(seed=5, n_bounce=256):
    """simple_box (12 triangles, 2 spheres) with its 24x20 camera rays plus
    random bounce rays from inside the box."""
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


# T = 48 takes the Pallas kernel's unrolled triangle loop, T = 100 its
# fori_loop (UNROLL_MAX = 64)
CASES = {"soup48": lambda: _soup(48), "soup100": lambda: _soup(100, seed=4),
         "simple_box": _box}


def _jvec(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


def _tvec(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3)])


def _unique_t(table, o, d):
    """Per ray: True where no two accepted triangles share the nearest t."""
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i]))[:, None]
            for a in (o, d) for i in range(3)]
    t, _, _, ok = K._mt_tile(table.reshape(-1, K.MT_FLOATS), *rays)
    t = torch.where(ok, t, K.F32_MAX)
    return ((t == t.min(dim=1, keepdim=True).values).sum(dim=1) <= 1).numpy()


@pytest.fixture
def pallas_mt():
    """The JAX package's Pallas kernels in their MT form, restored after."""
    saved = JP.PALLAS_IMPL
    JP.PALLAS_IMPL = "mt"
    try:
        yield
    finally:
        JP.PALLAS_IMPL = saved


@pytest.fixture
def port_mt():
    """The port's dense route in its MT form, restored after."""
    saved = TI.DENSE_KERNEL
    TI.DENSE_KERNEL = "mt"
    try:
        yield
    finally:
        TI.DENSE_KERNEL = saved


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jscene, o, d = CASES[request.param]()
    scene = scene_from_numpy(flatten(jscene), device="cpu")
    return jscene, scene, o, d


def test_pack_triangles_matches_jax(case):
    jscene, scene, _, _ = case
    want = np.asarray(JP.pack_triangles(jscene)).reshape(-1, 12)
    got = K.pack_triangles(scene).numpy().reshape(-1, 12)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :9], want[:, :9])
    near = np.isclose(got[:, 9:], want[:, 9:], rtol=0, atol=1e-7)
    ulps = np.abs(got[:, 9:].view(np.int32).astype(np.int64)
                  - want[:, 9:].view(np.int32).astype(np.int64))
    assert (near | (ulps <= 4)).all()


def test_nearest_matches_pallas_mt_interpret(case, pallas_mt):
    jscene, scene, o, d = case
    jt, jidx, jbu, jbv = map(np.asarray, JP.pallas_tri_intersect(
        jscene, _jvec(o), _jvec(d), interpret=True))
    table = K.pack_triangles(scene)
    t, idx, bu, bv = (a.numpy() for a in K.tri_intersect_mt(
        table, *_tvec(o), *_tvec(d)))
    assert idx.dtype == np.int32
    hit, jhit = idx >= 0, jidx >= 0
    assert (hit == jhit).mean() >= 0.999
    assert hit.mean() > 0.3
    both = hit & jhit
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    uniq = both & _unique_t(table, o, d)
    np.testing.assert_array_equal(idx[uniq], jidx[uniq])
    np.testing.assert_allclose(bu[uniq], jbu[uniq], atol=1e-5)
    np.testing.assert_allclose(bv[uniq], jbv[uniq], atol=1e-5)
    assert (t[~hit] == np.float32(3.4e38)).all()


def test_anyhit_matches_pallas_mt_interpret(case, pallas_mt):
    jscene, scene, o, d = case
    jt, jidx, _, _ = map(np.asarray, JP.pallas_tri_intersect(
        jscene, _jvec(o), _jvec(d), interpret=True))
    t_ref = np.where(jidx >= 0, jt, 1.0).astype(np.float32)
    table = K.pack_triangles(scene)
    for scale, off in ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                       (1.0, 3e-4), (1.0, 0.3)):
        dist = (t_ref * scale + off).astype(np.float32)
        want = np.asarray(JP.pallas_tri_occluded(
            jscene, _jvec(o), _jvec(d), jnp.asarray(dist), interpret=True))
        got = K.tri_occluded_mt(table, *_tvec(o), *_tvec(d),
                                torch.from_numpy(dist)).numpy()
        assert got.dtype == np.bool_
        assert (got == want).mean() >= 0.999, (scale, off)


def test_mt_rejects_a_ray_in_the_plane():
    """det == 0 (the ray lies in the triangle's plane) is rejected by the
    det != 0 test that only the MT form has, not by the division."""
    b = JBuilder()
    m = b.add_material()
    b.add_triangles(np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]],
                               np.float32), None, None, m)
    scene = scene_from_numpy(flatten(b.build()), device="cpu")
    table = K.pack_triangles(scene)
    o = [torch.tensor([-2.0, 0.0]), torch.tensor([0.0, 0.0]),
         torch.tensor([1.0, 0.0])]
    d = [torch.tensor([1.0, 0.0]), torch.tensor([0.0, 0.0]),
         torch.tensor([0.0, 1.0])]
    t, idx, _, _ = K.tri_intersect_mt(table, *o, *d)
    assert idx.tolist() == [-1, 0] and t[1].item() == 1.0
    assert K.tri_occluded_mt(table, *o, *d,
                             torch.tensor([5.0, 2.0])).tolist() == [False,
                                                                    True]


def test_intersect_core_and_shade_hit_match_jax_mt_route(case, port_mt):
    """The whole dense query, spheres included, per ray, against the JAX
    package's XLA MT route (its CPU default)."""
    jscene, scene, o, d = case
    assert JI._dense_impl() == "mt"
    jcore = JI.intersect_core(jscene, _jvec(o), _jvec(d))
    jrec = JI.shade_hit(jscene, _jvec(o), _jvec(d), jcore)
    core = TI.intersect_core(scene, _tvec(o), _tvec(d))
    rec = TI.shade_hit(scene, _tvec(o), _tvec(d), core)
    hit, jhit = core.hit.numpy(), np.asarray(jcore.hit)
    assert (hit == jhit).mean() >= 0.999
    both = hit & jhit
    np.testing.assert_allclose(core.t.numpy()[both],
                               np.asarray(jcore.t)[both], rtol=1e-5)
    uniq = both & _unique_t(K.pack_triangles(scene), o, d)
    for f in ("kind", "idx"):
        np.testing.assert_array_equal(getattr(core, f).numpy()[uniq],
                                      np.asarray(getattr(jcore, f))[uniq])
    np.testing.assert_array_equal(rec.mat.numpy()[uniq],
                                  np.asarray(jrec.mat)[uniq])
    for f in ("pos", "ng", "ns"):
        for c in range(3):
            np.testing.assert_allclose(
                getattr(rec, f)[c].numpy()[uniq],
                np.asarray(getattr(jrec, f)[c])[uniq], rtol=1e-5, atol=1e-5,
                err_msg=f)


def test_occluded_matches_jax_mt_route(case, port_mt):
    """Shadow query with spheres and a dead-lane mask."""
    jscene, scene, o, d = case
    r = np.random.RandomState(11)
    dist = (r.rand(o.shape[0]) * 3.0).astype(np.float32)
    mask = r.rand(o.shape[0]) > 0.2
    want = np.asarray(JI.occluded(jscene, _jvec(o), _jvec(d),
                                  jnp.asarray(dist), mask=jnp.asarray(mask)))
    got = TI.occluded(scene, _tvec(o), _tvec(d), torch.from_numpy(dist),
                      mask=torch.from_numpy(mask)).numpy()
    assert (got == want).mean() >= 0.999
    assert not got[~mask].any()


def test_dense_kernel_names_a_form(case, monkeypatch):
    _, scene, o, d = case
    monkeypatch.setattr(TI, "DENSE_KERNEL", "pallas")
    with pytest.raises(ValueError, match="DENSE_KERNEL"):
        TI.intersect_core(scene, _tvec(o), _tvec(d))


@pytest.mark.parametrize("bad", [
    "float64", "non-contiguous", "lengths", "woop-table", "too-many-triangles"])
def test_mt_wrapper_rejects_bad_inputs(bad):
    table = torch.zeros(12 * 2)
    rays = [torch.zeros(8) for _ in range(6)]
    if bad == "float64":
        rays[0] = rays[0].double()
    elif bad == "non-contiguous":
        rays[2] = torch.zeros(16)[::2]
    elif bad == "lengths":
        rays[3] = torch.zeros(9)
    elif bad == "woop-table":
        table = torch.zeros(13 * 2)
    else:
        table = torch.zeros(12 * 4096)
    with pytest.raises(ValueError):
        K.tri_intersect_mt(table, *rays)
    with pytest.raises(ValueError):
        K.tri_occluded_mt(table, *rays, torch.zeros(rays[0].shape[0]))


def test_mt_nearest_refuses_an_unaligned_table():
    """K3 and K4 read their table as float4: a view at a 1-float offset is
    refused on every device by both wrappers; an aligned copy is taken."""
    base = torch.zeros(12 * 2 + 1)
    table = base[1:]
    assert base.data_ptr() % 16 == 0 and table.is_contiguous()
    assert table.data_ptr() % 16 == 4
    rays = [torch.zeros(8) for _ in range(6)]
    with pytest.raises(ValueError, match="16-byte"):
        K.tri_intersect_mt(table, *rays)
    t, idx, _, _ = K.tri_intersect_mt(table.clone(), *rays)
    assert (idx == -1).all() and (t == np.float32(3.4e38)).all()
    with pytest.raises(ValueError, match="16-byte"):
        K.tri_occluded_mt(table, *rays, torch.ones(8))
    assert not K.tri_occluded_mt(table.clone(), *rays, torch.ones(8)).any()
