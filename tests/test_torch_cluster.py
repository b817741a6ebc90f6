"""Cluster tables and the cluster kernels' plain versions in the PyTorch port,
against the JAX package.

On the CPU the port's ``cluster_intersect`` / ``cluster_occluded`` /
``cluster_transmittance`` run their plain PyTorch versions, which the CUDA
kernels of ``csrc/bvh_walk.cu`` (nearest hit, any hit and transmittance)
match on the card (chip_smoke.py); tests/test_torch_bvh.py checks the BVH
they walk.
Tolerances:

- tables: the port's cluster arrays bit-equal to JAX ``build_clusters``
  (the same numpy calls), dtypes included;
- nearest hit: hit/miss agreement >= 99.9 %, t within rtol 1e-5 where
  both hit, idx equal and bu/bv within atol 1e-5 where t is unique (the
  TPU walk visits clusters in another order, so an exact t tie may keep
  another index); against the Moller-Trumbore routes (JAX's XLA dense
  route, the port's dense path) t within rtol 1e-4 and bu/bv within atol
  1e-4, as tests/test_pallas.py holds the JAX kernels to that route;
- any hit: the masks agree on >= 99.9 % of rays at every distance;
- transmittance: within rtol 1e-5 / atol 1e-6 (the product is taken in
  another order).

The JAX kernels run in interpret mode at tests/test_pallas.py's shapes (400
triangles, 128 rays, rows=8), one module-scoped call per kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import SHOWCASE_NU, SHOWCASE_NV, flatten
from tuturenderer_tpu.ops import intersect as JI
from tuturenderer_tpu.ops.pallas import cluster as JC
from tuturenderer_tpu.scene.data import SceneBuilder as JBuilder
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.models import meshes
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.ops import cluster as TC
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import cluster as K
from tuturenderer_tpu_torch.scene.data import SceneBuilder, scene_from_numpy
from tuturenderer_tpu_torch.utils.vec import Vec3

N_TRIS, N_RAYS = 400, 128
ALPHAS = (0.3, 0.85, 1.0)
# shadow distances: factors and offsets of the nearest hit's t
DISTS = ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5), (1.0, -5e-5),
         (1.0, 2e-4), (1.0, -2e-4))


def _soup_verts(seed=5, n=N_TRIS):
    r = np.random.RandomState(seed)
    centers = r.randn(n, 3) * 3.0
    return (centers[:, None, :] + 0.5 * r.randn(n, 3, 3)).astype(np.float32)


def _showcase_verts():
    verts, _ = meshes.uv_sphere(radius=1.0, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    return np.concatenate([
        verts, meshes.plane((0, -1, 0), (0, 0, 6), (6, 0, 0)),
        meshes.plane((0, 3, 0), (1, 0, 0), (0, 0, 1))])


def _build(mod, verts, spheres=False, **kw):
    """verts in three materials of alpha 0.3 / 0.85 / 1.0, optionally with
    two spheres, built with ``mod``'s SceneBuilder."""
    b = mod()
    mats = [b.add_material(alpha=a) for a in ALPHAS]
    for i, part in enumerate(np.array_split(verts, 3)):
        b.add_triangles(part, None, None, mats[i])
    if spheres:
        b.add_sphere((0.5, 0.2, 0.0), 0.8, mats[0])
        b.add_sphere((-2.0, 1.0, 1.0), 0.6, mats[2])
    return b.build(**kw)


def _rays(seed=7, n=N_RAYS, verts=None):
    """Half random rays, half aimed at triangle centroids (near edges)."""
    r = np.random.RandomState(seed)
    o = (r.randn(n, 3) * 4.0).astype(np.float32)
    d = r.randn(n, 3)
    if verts is not None:
        aim = verts[r.randint(0, len(verts), n // 2)].mean(axis=1) \
            + 0.2 * r.randn(n // 2, 3)
        d[n // 2:] = aim - o[n // 2:]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _jvec(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


def _cols(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)]


def _tvec(a):
    return Vec3(*_cols(a))


def _unique_t(clusters, o, d):
    """Per ray: True where no two accepted triangles share the nearest t."""
    rows, _ = K.real_rows(clusters)
    rays = [c[:, None] for c in _cols(o) + _cols(d)]
    t, _, _, ok = K._test_tile(rows, *rays)
    t = torch.where(ok, t, K.F32_MAX)
    return ((t == t.min(dim=1, keepdim=True).values).sum(dim=1) <= 1).numpy()


def _dist_sets(t, hit, n_rays):
    t_ref = np.where(hit, t, 10.0).astype(np.float32)
    return np.concatenate([(t_ref * f + off).astype(np.float32)
                           for f, off in DISTS])


@pytest.fixture(scope="module")
def soup():
    """(JAX cluster scene, port scene from its tables, o, d)."""
    verts = _soup_verts()
    jscene = _build(JBuilder, verts, use_bvh=True)
    scene = scene_from_numpy(flatten(jscene), device="cpu")
    o, d = _rays(verts=verts)
    return jscene, scene, o, d


@pytest.fixture(scope="module")
def jax_walk(soup):
    """One interpret-mode call of each JAX walk kernel: K5 on the rays, K6
    on the rays repeated for every distance set, K7 on the rays at 2x the
    hit distance and at a distance past the whole soup."""
    jscene, _, o, d = soup
    cl = jscene.clusters
    near = [np.asarray(a) for a in JC.cluster_intersect(
        cl, _jvec(o), _jvec(d), rows=8, interpret=True)]
    k = len(DISTS)
    dist6 = _dist_sets(near[0], near[1] >= 0, N_RAYS)
    occ = np.asarray(JC.cluster_occluded(
        cl, _jvec(np.tile(o, (k, 1))), _jvec(np.tile(d, (k, 1))),
        jnp.asarray(dist6), rows=8, interpret=True))
    dist7 = np.concatenate([dist6[2 * N_RAYS:3 * N_RAYS],
                            np.full(N_RAYS, 30.0, np.float32)])
    trans = np.asarray(JC.cluster_transmittance(
        cl, _jvec(np.tile(o, (2, 1))), _jvec(np.tile(d, (2, 1))),
        jnp.asarray(dist7), rows=8, interpret=True))
    return near, dist6, occ, dist7, trans


# ------------------------------------------------------------ tables

@pytest.mark.parametrize("alphas", [False, True], ids=["opaque", "alphas"])
@pytest.mark.parametrize("which", ["soup400", "showcase4236"])
def test_tables_bit_equal_jax(which, alphas):
    verts = _soup_verts() if which == "soup400" else _showcase_verts()
    a = np.random.RandomState(2).choice(ALPHAS, len(verts)) \
        .astype(np.float32) if alphas else None
    want = JC.build_clusters(verts, alphas=a)
    got = TC.build_clusters(verts, alphas=a)
    assert sorted(got) == sorted(want._fields)
    for k in want._fields:
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["aabb"].shape[0] % TC.C_ALIGN == 0


@pytest.mark.parametrize("which", ["soup400", "showcase4236", "plane4096"])
def test_tree_leaves_cover_every_real_cluster_once(which):
    """``build_tree``'s links, and the BVH's top nodes built on them: each
    child box holds its subtree's clusters strictly inside (padded
    outward), flat clusters included."""
    if which == "plane4096":    # flat clusters: zero-thickness boxes
        verts = meshes.plane((0, -1, 0), (0, 0, 6), (6, 0, 0), 32, 64)
    else:
        verts = _soup_verts() if which == "soup400" else _showcase_verts()
    arrays = TC.build_clusters(verts)
    aabb = arrays["aabb"]
    link = TC.build_tree(aabb)
    assert link.dtype == np.int32 and link.shape[1] == 2
    real = np.nonzero((aabb[:, :3] <= aabb[:, 3:6]).all(axis=1))[0]
    leaf = link[:, 0] < 0
    np.testing.assert_array_equal(np.sort(-1 - link[leaf, 0]), real)
    np.testing.assert_array_equal(link[leaf, 1], -1)
    assert len(link) == 2 * len(real) - 1
    # every node but the root is some inner node's child, exactly once
    np.testing.assert_array_equal(np.sort(link[~leaf].ravel()),
                                  np.arange(1, len(link)))

    def clusters_under(k):
        if link[k, 0] < 0:
            return [-1 - link[k, 0]]
        return clusters_under(link[k, 0]) + clusters_under(link[k, 1])

    # the tree's inner nodes are the BVH's first nodes, in the same order
    nodes = TC.clusters_from_numpy(arrays, device="cpu").bvh_nodes.numpy()
    kid_box = [nodes[:, [0, 2, 8, 1, 3, 9]], nodes[:, [4, 6, 10, 5, 7, 11]]]
    bvh_link = nodes.view(np.int32)[:, 12:14]
    top = np.nonzero(~leaf)[0]
    for j, k in enumerate(top):
        for slot in (0, 1):
            kid = link[k, slot]
            boxes = aabb[clusters_under(kid)]
            box = kid_box[slot][j]
            assert (box[:3] < boxes[:, :3].min(axis=0)).all() and \
                (box[3:] > boxes[:, 3:6].max(axis=0)).all(), (k, slot)
            assert (box[3:] - box[:3] > 1e-4).all()
            if link[kid, 0] >= 0:       # an inner node of the tree
                assert bvh_link[j, slot] == np.searchsorted(top, kid)
            else:                       # a cluster: the root of its rows
                assert not 0 <= bvh_link[j, slot] < len(top)


def test_scene_from_numpy_equals_port_build():
    """A JAX cluster scene imported through scene_from_numpy (its bvh.*
    keys ignored) equals the port's own build of the preset."""
    from tuturenderer_tpu.models.scenes import sphere_showcase as j_showcase
    jscene, _ = j_showcase(24, 20, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    arrays = flatten(jscene)
    assert any(k.startswith("bvh.") for k in arrays)
    got = flatten(scene_from_numpy(arrays, device="cpu"))
    want = flatten(sphere_showcase(24, 20, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                                   device="cpu")[0])
    assert sorted(got) == sorted(want)
    assert "clusters.bvh_nodes" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_builder_attaches_clusters_from_4096_triangles():
    verts = _soup_verts(n=4096)
    assert _build(SceneBuilder, verts[:4095], device="cpu").clusters is None
    big = _build(SceneBuilder, verts, device="cpu")
    assert big.clusters is not None
    small = _build(SceneBuilder, verts[:10], use_bvh=True, device="cpu")
    assert int((small.clusters.tri_idx >= 0).sum()) == 10
    # per-triangle alphas from the materials, in slot 13
    rows, virt = K.real_rows(big.clusters)
    tri = big.clusters.tri_idx.reshape(-1)[virt].long()
    want = big.materials.alpha[big.tmat[tri].long()]
    torch.testing.assert_close(rows[:, 13], want, rtol=0, atol=0)


# ------------------------------------ plain versions vs the JAX kernels

def test_nearest_plain_matches_pallas_interpret(soup, jax_walk):
    _, scene, o, d = soup
    jt, jidx, jbu, jbv = jax_walk[0]
    t, idx, bu, bv = (a.numpy() for a in K.cluster_intersect(
        scene.clusters, *_cols(o), *_cols(d)))
    assert idx.dtype == np.int32 and t.dtype == np.float32
    hit, jhit = idx >= 0, jidx >= 0
    assert (hit == jhit).mean() >= 0.999
    assert hit.mean() > 0.3
    both = hit & jhit
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5)
    uniq = both & _unique_t(scene.clusters, o, d)
    np.testing.assert_array_equal(idx[uniq], jidx[uniq])
    np.testing.assert_allclose(bu[uniq], jbu[uniq], atol=1e-5)
    np.testing.assert_allclose(bv[uniq], jbv[uniq], atol=1e-5)
    assert (t[~hit] == np.float32(3.4e38)).all()


def test_anyhit_plain_matches_pallas_interpret(soup, jax_walk):
    _, scene, o, d = soup
    _, dist6, want, _, _ = jax_walk
    for i, (f, off) in enumerate(DISTS):
        sl = slice(i * N_RAYS, (i + 1) * N_RAYS)
        got = K.cluster_occluded(scene.clusters, *_cols(o), *_cols(d),
                                 torch.from_numpy(dist6[sl])).numpy()
        assert got.dtype == np.bool_
        assert (got == want[sl].astype(bool)).mean() >= 0.999, (f, off)
    assert want.any() and not want.all()


def test_transmit_plain_matches_pallas_interpret(soup, jax_walk):
    _, scene, o, d = soup
    _, _, _, dist7, want = jax_walk
    got = K.cluster_transmittance(
        scene.clusters, *_cols(np.tile(o, (2, 1))),
        *_cols(np.tile(d, (2, 1))), torch.from_numpy(dist7)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # every alpha appears: partial and full attenuation both occur
    assert (want < 1.0).any() and (want > 0.0).any() and (want == 0.0).any()
    assert (want < 0.99).sum() > (want == 0.0).sum()


# -------------------------------------- against the dense routes

@pytest.fixture(scope="module")
def dense_pair():
    """The soup with two spheres, built by the port as a cluster scene and
    as a dense scene, and by JAX as a dense scene."""
    verts = _soup_verts()
    cl = _build(SceneBuilder, verts, spheres=True, use_bvh=True,
                device="cpu")
    dense = _build(SceneBuilder, verts, spheres=True, use_bvh=False,
                   device="cpu")
    jdense = _build(JBuilder, verts, spheres=True, use_bvh=False)
    o, d = _rays(seed=9, verts=verts)
    return cl, dense, jdense, o, d


def _xla(fn, *args, **kw):
    old = JI.DENSE_IMPL
    JI.DENSE_IMPL = "mt"
    try:
        return fn(*args, **kw)
    finally:
        JI.DENSE_IMPL = old


def _assert_cores_close(got, want, uniq):
    hit, whit = got.hit.numpy(), np.asarray(want.hit)
    assert (hit == whit).mean() >= 0.999
    both = hit & whit
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both],
                               rtol=1e-4)
    u = both & uniq
    for f in ("kind", "idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[u],
                                      np.asarray(getattr(want, f))[u])
    tri = u & (got.kind.numpy() == 0)
    for f in ("bu", "bv"):
        np.testing.assert_allclose(getattr(got, f).numpy()[tri],
                                   np.asarray(getattr(want, f))[tri],
                                   atol=1e-4)


@pytest.mark.parametrize("route", ["jax-xla-dense", "port-dense"])
def test_cluster_queries_match_dense_routes(dense_pair, route):
    """intersect_core, occluded (with a dead-lane mask) and transmittance of
    the cluster scene against a dense route on the same geometry and
    spheres."""
    cl, dense, jdense, o, d = dense_pair
    uniq = _unique_t(cl.clusters, o, d)
    core = TI.intersect_core(cl, _tvec(o), _tvec(d))
    r = np.random.RandomState(11)
    dist = (r.rand(len(o)) * 8.0).astype(np.float32)
    mask = r.rand(len(o)) > 0.2
    occ = TI.occluded(cl, _tvec(o), _tvec(d), torch.from_numpy(dist),
                      mask=torch.from_numpy(mask)).numpy()
    trans = TI.transmittance(cl, _tvec(o), _tvec(d), torch.from_numpy(dist),
                             mask=torch.from_numpy(mask)).numpy()
    if route == "port-dense":
        want_core = TI.intersect_core(dense, _tvec(o), _tvec(d))
        want_occ = TI.occluded(dense, _tvec(o), _tvec(d),
                               torch.from_numpy(dist),
                               mask=torch.from_numpy(mask)).numpy()
        want_trans = TI.transmittance(dense, _tvec(o), _tvec(d),
                                      torch.from_numpy(dist),
                                      mask=torch.from_numpy(mask)).numpy()
    else:
        jo, jd = _jvec(o), _jvec(d)
        want_core = _xla(JI.intersect_core, jdense, jo, jd)
        want_occ = np.asarray(_xla(JI.occluded, jdense, jo, jd,
                                   jnp.asarray(dist),
                                   mask=jnp.asarray(mask)))
        want_trans = np.asarray(_xla(JI.transmittance, jdense, jo, jd,
                                     jnp.asarray(dist),
                                     mask=jnp.asarray(mask)))
    _assert_cores_close(core, want_core, uniq)
    assert core.hit.numpy().mean() > 0.3
    assert (occ == want_occ).mean() >= 0.999
    assert not occ[~mask].any() and occ.any()
    np.testing.assert_allclose(trans, want_trans, rtol=1e-5, atol=1e-6)
    assert (trans[~mask] == 1.0).all() and (trans < 1.0).any()


def test_dead_lanes_miss(soup):
    _, scene, o, d = soup
    none = torch.zeros(len(o), dtype=torch.bool)
    assert (TI.intersect_core(scene, _tvec(o), _tvec(d), mask=none).idx
            == -1).all()
    far = torch.full((len(o),), 100.0)
    assert not TI.occluded(scene, _tvec(o), _tvec(d), far, mask=none).any()
    assert (TI.transmittance(scene, _tvec(o), _tvec(d), far, mask=none)
            == 1.0).all()


def test_test_count_is_rays_times_real_rows(soup):
    _, scene, o, d = soup
    count = torch.zeros(1, dtype=torch.int64)
    K.cluster_intersect(scene.clusters, *_cols(o), *_cols(d),
                        test_count=count)
    assert int(count) == N_RAYS * N_TRIS


def test_occluded_plain_counts_only_live_rays(soup):
    # a shadow call's dead lanes carry dist <= 0 (or NaN): never blocked,
    # never tested
    _, scene, o, d = soup
    dist = torch.full((N_RAYS,), 100.0)
    dist[0::4], dist[1::4], dist[2::4] = 0.0, -1.0, float("nan")
    count = torch.zeros(1, dtype=torch.int64)
    blocked = K.cluster_occluded(scene.clusters, *_cols(o), *_cols(d), dist,
                                 test_count=count)
    live = dist > 0.0
    assert int(count) == int(live.sum()) * N_TRIS
    assert not blocked[~live].any()
    assert torch.equal(blocked[live], K.cluster_occluded(
        scene.clusters, *(c[live] for c in _cols(o) + _cols(d)), dist[live]))


def _good_args(soup):
    _, scene, o, d = soup
    return scene.clusters, _cols(o) + _cols(d)


@pytest.mark.parametrize("bad", [
    "float64", "2-D", "non-contiguous", "lengths", "woop-length",
    "tri_idx-dtype", "bvh_nodes-dtype", "test_count-dtype",
    "bvh_rows-length", "bvh_nodes-width", "bvh_virt-dtype",
    "bvh_virt-length"])
def test_wrappers_reject_bad_inputs(soup, bad):
    import dataclasses
    cl, rays = _good_args(soup)
    count = None
    if bad == "float64":
        rays[0] = rays[0].double()
    elif bad == "2-D":
        rays[1] = rays[1].reshape(2, -1)
    elif bad == "non-contiguous":
        rays[2] = torch.zeros(2 * N_RAYS)[::2]
    elif bad == "lengths":
        rays[3] = torch.zeros(N_RAYS + 1)
    elif bad == "woop-length":
        cl = dataclasses.replace(cl, woop=cl.woop[:-1])
    elif bad == "tri_idx-dtype":
        cl = dataclasses.replace(cl, tri_idx=cl.tri_idx.long())
    elif bad == "bvh_nodes-dtype":
        cl = dataclasses.replace(cl, bvh_nodes=cl.bvh_nodes.view(torch.int32))
    elif bad == "bvh_rows-length":
        cl = dataclasses.replace(cl, bvh_rows=cl.bvh_rows[:-1])
    elif bad == "bvh_nodes-width":
        cl = dataclasses.replace(cl, bvh_nodes=cl.bvh_nodes[:, :12]
                                 .contiguous())
    elif bad == "bvh_virt-dtype":
        cl = dataclasses.replace(cl, bvh_virt=cl.bvh_virt.long())
    elif bad == "bvh_virt-length":
        # rows and ids agree with each other, not with tri_idx's real rows
        cl = dataclasses.replace(cl, bvh_rows=cl.bvh_rows[:-1],
                                 bvh_virt=cl.bvh_virt[:-1])
    else:
        count = torch.zeros(1, dtype=torch.int32)
    dist = torch.ones(N_RAYS)
    with pytest.raises(ValueError):
        K.cluster_intersect(cl, *rays, test_count=count)
    with pytest.raises(ValueError):
        K.cluster_occluded(cl, *rays, dist, test_count=count)
    with pytest.raises(ValueError):
        K.cluster_transmittance(cl, *rays, dist, test_count=count)
