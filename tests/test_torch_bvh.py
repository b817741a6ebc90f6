"""The port's BVH over the cluster tables (``ops/cluster.py::build_bvh``),
the tree ``csrc/bvh_walk.cu`` walks for the nearest hit (K5), the shadow
any hit (K6) and the alpha-shadow transmittance (K7), checked on the CPU
where the kernel cannot run.

The scenes: a 400-triangle soup, sphere_showcase's geometry at 4,236
triangles and a flat 4,096-triangle plane (zero-thickness boxes). The
tables hold exactly: every real row in one leaf, the rows bit-equal to the
Woop rows, every child box around its subtree's triangles, tables from the
JAX package's arrays bit-equal to the port's own. The walk
(``torch_port_util.bvh_walk``, float32 numpy in the kernel's order) is held
to the dense plain versions exactly: t bit-equal, the plain version's row
among the rows the walk tested, idx equal where t is unique and bu/bv where
idx is, the any-hit masks equal at every shadow distance; the
transmittance, alphas read through the rows' virtual ids from ``woop`` and
the walk ending at a product of 0, within rtol 1e-5 / atol 1e-6 of the
plain version (the product is taken in walk order, not row order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import SHOWCASE_NU, SHOWCASE_NV, bvh_walk
from tuturenderer_tpu.ops.pallas import cluster as JC
from tuturenderer_tpu_torch.models import meshes
from tuturenderer_tpu_torch.ops import cluster as TC
from tuturenderer_tpu_torch.ops.cuda import cluster as K

SCENES = ["soup400", "showcase4236", "plane4096"]
N_RAYS = 192
DISTS = ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5), (1.0, -5e-5),
         (1.0, 2e-4), (1.0, -2e-4))
ALPHAS = (0.3, 0.85, 1.0)
FAR = 100.0         # a shadow distance past every scene


def _verts(which):
    if which == "soup400":
        r = np.random.RandomState(5)
        centers = r.randn(400, 3) * 3.0
        return (centers[:, None, :] + 0.5 * r.randn(400, 3, 3)) \
            .astype(np.float32)
    if which == "plane4096":
        return meshes.plane((0, -1, 0), (0, 0, 6), (6, 0, 0), 32, 64)
    verts, _ = meshes.uv_sphere(radius=1.0, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    return np.concatenate([
        verts, meshes.plane((0, -1, 0), (0, 0, 6), (6, 0, 0)),
        meshes.plane((0, 3, 0), (1, 0, 0), (0, 0, 1))])


def _rays(verts, seed=3):
    """A third random rays, a third aimed near triangle centroids, a third
    at vertices and edge midpoints (shared edges: t ties)."""
    r = np.random.RandomState(seed)
    o = (r.randn(N_RAYS, 3) * 4.0).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5       # above the plane's y = -1
    d = r.randn(N_RAYS, 3)
    k = N_RAYS // 3
    tri = verts[r.randint(0, len(verts), 2 * k)]
    d[k:2 * k] = tri[:k].mean(axis=1) + 0.05 * r.randn(k, 3) - o[k:2 * k]
    w = r.choice([0.0, 0.5], size=(k, 1))
    d[2 * k:] = tri[k:, 0] * (1 - w) + tri[k:, 1] * w - o[2 * k:]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", params=SCENES)
def table(request):
    """(name, verts, JAX-layout arrays, port Clusters on the CPU)."""
    verts = _verts(request.param)
    arrays = TC.build_clusters(verts)
    return request.param, verts, arrays, TC.clusters_from_numpy(
        arrays, device="cpu")


def _leaves(nodes):
    """[(first, count)] of every leaf link in the node table."""
    links = nodes.view(np.int32)[:, 12:14].ravel()
    code = -1 - links[links < 0].astype(np.int64)
    return code >> TC.LEAF_BITS, code & ((1 << TC.LEAF_BITS) - 1)


def test_every_real_row_lies_in_exactly_one_leaf(table):
    _, verts, _, cl = table
    nodes = cl.bvh_nodes.numpy()
    first, count = _leaves(nodes)
    assert count.max() <= TC.BVH_LEAF
    assert (count >= 1).all()
    covered = np.zeros(len(verts), np.int64)
    for f, c in zip(first, count):
        covered[f:f + c] += 1
    np.testing.assert_array_equal(covered, 1)
    # every inner node but the root is some node's child, exactly once
    links = nodes.view(np.int32)[:, 12:14].ravel()
    np.testing.assert_array_equal(np.sort(links[links >= 0]),
                                  np.arange(1, len(nodes)))


def test_rows_equal_the_woop_rows_bit_for_bit(table):
    _, verts, arrays, cl = table
    virt = cl.bvh_virt.numpy()
    assert len(np.unique(virt)) == len(virt) == len(verts)
    woop = arrays["woop"].reshape(-1, 8 * 128)[:, :64 * TC.WOOP_F] \
        .reshape(-1, TC.WOOP_F)
    np.testing.assert_array_equal(cl.bvh_rows.numpy().view(np.int32),
                                  woop[virt, :12].view(np.int32))
    assert (arrays["tri_idx"].reshape(-1)[virt] >= 0).all()


def test_child_boxes_contain_their_subtrees(table):
    _, verts, arrays, cl = table
    nodes = cl.bvh_nodes.numpy()
    links = nodes.view(np.int32)[:, 12:14]
    tri = arrays["tri_idx"].reshape(-1)[cl.bvh_virt.numpy()]
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    kid_box = [nodes[:, [0, 2, 8, 1, 3, 9]], nodes[:, [4, 6, 10, 5, 7, 11]]]

    def bounds(link):
        if link < 0:
            first = (-1 - link) >> TC.LEAF_BITS
            count = (-1 - link) & ((1 << TC.LEAF_BITS) - 1)
            rows = tri[first:first + count]
            return lo[rows].min(axis=0), hi[rows].max(axis=0)
        got = [bounds(int(k)) for k in links[link]]
        for slot, (blo, bhi) in enumerate(got):
            box = kid_box[slot][link]
            assert (box[:3] < blo).all() and (box[3:] > bhi).all(), \
                (link, slot)
        return (np.minimum(got[0][0], got[1][0]),
                np.maximum(got[0][1], got[1][1]))

    bounds(0)
    kids = np.concatenate(kid_box)
    assert (kids[:, 3:] - kids[:, :3] > 1e-4).all()


def test_shapes_dtypes_and_16_byte_rows(table):
    _, verts, _, cl = table
    k = cl.bvh_nodes.shape[0]
    assert cl.bvh_nodes.dtype == torch.float32 and \
        tuple(cl.bvh_nodes.shape) == (k, TC.NODE_F)
    assert cl.bvh_rows.dtype == torch.float32 and \
        tuple(cl.bvh_rows.shape) == (len(verts), TC.ROW_F)
    assert cl.bvh_virt.dtype == torch.int32 and \
        tuple(cl.bvh_virt.shape) == (len(verts),)
    for a, row_bytes in ((cl.bvh_nodes, 64), (cl.bvh_rows, 48)):
        assert a.is_contiguous()
        assert a.stride(0) * a.element_size() == row_bytes
        assert a.data_ptr() % 16 == 0
    # leaves of at most 4 rows under a full cluster of 64: 15 inner nodes
    n_clusters = int((cl.tri_idx[:, 0] >= 0).sum())
    assert k >= n_clusters - 1 + (len(verts) // 64) * 15


def test_tables_from_jax_arrays_equal_the_port_build(table):
    name, verts, _, cl = table
    want = JC.build_clusters(verts)
    got = TC.clusters_from_numpy({k: np.asarray(getattr(want, k))
                                  for k in want._fields}, device="cpu")
    for f in ("bvh_nodes", "bvh_rows", "bvh_virt"):
        a, b = getattr(got, f), getattr(cl, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32), err_msg=f)


def _cols(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)]


@pytest.fixture(scope="module")
def walked(table):
    """The numpy walk's nearest hits and the plain version's, on the
    scene's rays."""
    _, verts, arrays, cl = table
    o, d = _rays(verts)
    walk = bvh_walk(cl.bvh_nodes.numpy(), cl.bvh_rows.numpy(), o, d)
    plain = [a.numpy() for a in K.cluster_intersect_plain(
        cl, *_cols(o), *_cols(d))]
    return o, d, walk, plain


def test_walk_reaches_the_plain_versions_nearest_hit(table, walked):
    _, verts, arrays, cl = table
    o, d, walk, (tp, ip, up, vp) = walked
    tri = arrays["tri_idx"].reshape(-1)[cl.bvh_virt.numpy()]
    row_of = np.full(len(verts), -1)
    row_of[tri] = np.arange(len(tri))
    t = np.array([w[0] for w in walk], np.float32)
    row = np.array([w[1] for w in walk])
    idx = np.where(row >= 0, tri[row], -1)
    hit = ip >= 0
    assert hit.mean() > 0.4
    np.testing.assert_array_equal(t.view(np.int32), tp.view(np.int32))
    for i in np.nonzero(hit)[0]:
        assert row_of[ip[i]] in walk[i][4], i
    # t bit-equal: a differing idx is a triangle at the same t
    rows = K.real_rows(cl)[0]
    for i in np.nonzero(idx != ip)[0]:
        tt, _, _, ok = K._test_tile(rows, *[torch.tensor([[v]]) for v in
                                            (*o[i], *d[i])])
        assert int((ok & (tt == float(tp[i]))).sum()) >= 2, i
    same = idx == ip
    assert same.mean() > 0.9
    bu = np.array([w[2] for w in walk], np.float32)
    bv = np.array([w[3] for w in walk], np.float32)
    np.testing.assert_array_equal(bu[same], up[same])
    np.testing.assert_array_equal(bv[same], vp[same])


def test_walk_any_hit_equals_the_plain_mask(table, walked):
    _, _, _, cl = table
    o, d, _, (tp, ip, _, _) = walked
    t_ref = np.where(ip >= 0, tp, 10.0).astype(np.float32)
    masks = []
    for f, off in DISTS:
        dist = (t_ref * np.float32(f) + np.float32(off)).astype(np.float32)
        got = np.array([w[0] for w in bvh_walk(
            cl.bvh_nodes.numpy(), cl.bvh_rows.numpy(), o, d, dist)])
        want = K.cluster_occluded_plain(cl, *_cols(o), *_cols(d),
                                        torch.from_numpy(dist)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((f, off)))
        masks.append(want)
    masks = np.stack(masks)
    assert masks.any() and not masks.all()


def _transmit(cl, o, d, dist):
    """(the walk's transmittance, the plain version's) at ``dist``."""
    got = np.array([w[0] for w in bvh_walk(
        cl.bvh_nodes.numpy(), cl.bvh_rows.numpy(), o, d, dist,
        transmit=(cl.bvh_virt.numpy(), cl.woop.numpy()))], np.float32)
    want = K.cluster_transmittance_plain(cl, *_cols(o), *_cols(d),
                                         torch.from_numpy(dist)).numpy()
    return got, want


def test_walk_transmittance_equals_the_plain_version(table, walked):
    """Alphas drawn from {0.3, 0.85, 1.0} per triangle; the shadow distances
    of the any-hit test and one past the scene."""
    name, verts, _, _ = table
    o, d, _, (tp, ip, _, _) = walked
    alphas = np.random.RandomState(4).choice(ALPHAS, len(verts)) \
        .astype(np.float32)
    cl = TC.clusters_from_numpy(TC.build_clusters(verts, alphas=alphas),
                                device="cpu")
    t_ref = np.where(ip >= 0, tp, 10.0).astype(np.float32)
    sets = [(t_ref * np.float32(f) + np.float32(off)).astype(np.float32)
            for f, off in DISTS] + [np.full(len(o), FAR, np.float32)]
    trans = []
    for dist in sets:
        got, want = _transmit(cl, o, d, dist)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        trans.append(want)
    trans = np.stack(trans)
    # partial and full attenuation both occur, and the exit at 0 is taken
    assert (trans == 0.0).any() and ((trans > 0.0) & (trans < 1.0)).any()
    assert (trans == 1.0).any()


def test_walk_transmittance_follows_replaced_alphas(table, walked):
    """``dataclasses.replace(clusters, woop=...)`` with new alphas: the
    walk (which reads alpha from woop) and the plain version both follow,
    with the BVH unchanged."""
    _, _, _, cl = table
    o, d, _, _ = walked
    far = np.full(len(o), FAR, np.float32)
    opaque, want = _transmit(cl, o, d, far)
    np.testing.assert_array_equal(opaque, want)
    assert set(np.unique(want)) == {0.0, 1.0}
    woop = cl.woop.clone()
    rows = woop.view(woop.shape[0], -1)[:, :64 * TC.WOOP_F] \
        .view(-1, 64, TC.WOOP_F)
    pick = torch.from_numpy(np.random.RandomState(6).randint(
        0, 2, rows.shape[:2]))
    rows[..., 13] = torch.tensor([0.5, 0.25])[pick]
    glass = dataclasses.replace(cl, woop=woop)
    got, want = _transmit(glass, o, d, far)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    crossed = opaque == 0.0
    assert crossed.any()
    assert (want[crossed] > 0.0).all() and (want[crossed] < 1.0).all()
    np.testing.assert_array_equal(want[~crossed], 1.0)


@pytest.mark.parametrize("slot", [0, 3, 10], ids=["r1x", "c1", "r3z"])
def test_replacing_woop_geometry_raises(table, walked, slot):
    """Construction holds every real row's first 12 Woop floats to its copy
    in ``bvh_rows``, bit for bit: new alphas alone pass, and K7's plain
    version reads them; one real row moved by one ulp in any of the 12
    raises and names the fix."""
    _, _, _, cl = table
    o, d, _, _ = walked
    woop = cl.woop.clone()
    rows = woop.view(woop.shape[0], -1)[:, :64 * TC.WOOP_F] \
        .view(-1, 64, TC.WOOP_F)
    rows[..., 13] = 0.5
    glass = dataclasses.replace(cl, woop=woop.clone())
    far = np.full(len(o), FAR, np.float32)
    opaque = _transmit(cl, o, d, far)[1]
    want = _transmit(glass, o, d, far)[1]
    crossed = opaque == 0.0
    assert crossed.any() and (want[crossed] > 0.0).all()
    real = torch.nonzero(cl.tri_idx >= 0)
    c, s = (int(x) for x in real[len(real) // 2])
    rows[c, s, slot] = torch.nextafter(rows[c, s, slot],
                                       torch.tensor(np.inf))
    with pytest.raises(ValueError, match="rebuild the tables"):
        dataclasses.replace(cl, woop=woop)
