"""The port's CUDA kernels on the card; every test here skips without a CUDA
device. This file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact. The kernels are built with --fmad=false and compute the
plain versions' float32 expressions in the same order (the RNG kernel
their integer hash, in uint32) (the dense kernels
in both forms, Woop and Moller-Trumbore, and the visit-walk probe). The
cluster kernels (the BVH walk of the nearest hit, the any hit and the
transmittance) visit triangles in another order than their plain
versions, so an exact t tie may keep another index (bu/bv are compared
where idx is equal) and the transmittance product differs within rtol
1e-5 / atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import special_rays, special_verts
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.camera import primary_ray
from tuturenderer_tpu_torch.integrators.path import render
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import cluster as C
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import SceneBuilder
from tuturenderer_tpu_torch.scene.presets import simple_box
from tuturenderer_tpu_torch.tools import proto_visit as P
from tuturenderer_tpu_torch.utils import cuda_graph, profiling
from tuturenderer_tpu_torch.utils import rng

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup(dev, n_tris=4095, n_rays=4096):
    r = np.random.RandomState(1)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    b.add_triangles((centers[:, None, :] + 0.6 * r.randn(n_tris, 3, 3))
                    .astype(np.float32), None, None, m)
    o = torch.from_numpy((r.randn(n_rays, 3) * 3).astype(np.float32))
    d = torch.from_numpy(r.randn(n_rays, 3).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    return b.build(device=dev), o.to(dev), d.to(dev)


def _box(dev):
    scene, cam = simple_box(64, 48, device=dev)
    lane = torch.arange(64 * 48, device=dev)
    o, d, _ = primary_ray(cam, lane % 64, lane // 64)
    return scene, torch.stack(list(o), 1), torch.stack(list(d), 1)


@pytest.mark.parametrize("which", ["simple_box", "soup4095"])
def test_kernels_equal_plain_versions(dev, which):
    scene, o, d = _box(dev) if which == "simple_box" else _soup(dev)
    table = K.pack_triangles_woop(scene)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    before = dict(K.LAUNCHES)
    got = K.tri_intersect(table, *rays)
    want = K.tri_intersect_plain(table, *rays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert bool((want[1] >= 0).any())
    for scale in (0.5, 1.0, 2.0):
        dist = torch.where(want[1] >= 0, want[0], 1.0) * scale
        torch.testing.assert_close(K.tri_occluded(table, *rays, dist),
                                   K.tri_occluded_plain(table, *rays, dist))
    assert K.LAUNCHES["nearest"] == before["nearest"] + 1
    assert K.LAUNCHES["anyhit"] == before["anyhit"] + 3


def test_render_goes_through_the_kernels(dev):
    scene, cam = simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=2, max_depth=3)
    before = dict(K.LAUNCHES)
    img = render(scene, cam, opts, seed=1)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert K.LAUNCHES["nearest"] - before["nearest"] == (3 + 2) * 2
    assert K.LAUNCHES["anyhit"] - before["anyhit"] == (3 + 1) * 2


def _mesh(dev, n_rays=8192):
    """sphere_showcase at 4,236 triangles (cluster tables) with camera rays
    and random rays from inside the scene."""
    scene, cam = sphere_showcase(64, 64, nu=46, nv=46, device=dev)
    lane = torch.arange(64 * 64, device=dev)
    o, d, _ = primary_ray(cam, lane % 64, lane // 64)
    g = torch.Generator(device=dev).manual_seed(3)
    ob = torch.rand((n_rays, 3), generator=g, device=dev) * 4.0 - 2.0
    db = torch.randn((n_rays, 3), generator=g, device=dev)
    db = db / db.norm(dim=1, keepdim=True)
    return scene, torch.cat([torch.stack(list(o), 1), ob]), \
        torch.cat([torch.stack(list(d), 1), db])


def _alpha_table(cl, dev, alphas=(0.3, 0.85, 1.0)):
    """The clusters with every real row's alpha (slot 13) taken in turn
    from ``alphas``; the transmittance kernel reads alpha from ``woop``."""
    alpha = cl.woop.clone()
    rows = alpha.view(alpha.shape[0], -1)[:, :64 * 14].view(-1, 64, 14)
    rows[..., 13] = torch.tensor(alphas, device=dev)[
        torch.arange(rows.shape[1], device=dev) % len(alphas)]
    return dataclasses.replace(cl, woop=alpha)


def _nearest_equal(got, want):
    """t bit-equal; bu/bv bit-equal wherever idx is; idx equal but at exact
    t ties."""
    t, idx, bu, bv = got
    tp, ip, up, vp = want
    torch.testing.assert_close(t, tp, rtol=0, atol=0)
    same = idx == ip
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(bu[same], up[same], rtol=0, atol=0)
    torch.testing.assert_close(bv[same], vp[same], rtol=0, atol=0)


def test_cluster_kernels_equal_plain_versions(dev):
    """The BVH walk's three modes (K5, K6, K7) against the plain
    versions."""
    scene, o, d = _mesh(dev)
    cl = scene.clusters
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    before = dict(K.LAUNCHES)
    want = C.cluster_intersect_plain(cl, *rays)
    assert bool((want[1] >= 0).any())
    _nearest_equal(C.cluster_intersect(cl, *rays), want)
    cl_alpha = _alpha_table(cl, dev)
    t_ref = torch.where(want[1] >= 0, want[0], 10.0)
    for scale, off in ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                       (1.0, -2e-4)):
        dist = t_ref * scale + off
        blocked = C.cluster_occluded_plain(cl, *rays, dist)
        torch.testing.assert_close(C.cluster_occluded(cl, *rays, dist),
                                   blocked)
        torch.testing.assert_close(
            C.cluster_transmittance(cl_alpha, *rays, dist),
            C.cluster_transmittance_plain(cl_alpha, *rays, dist),
            rtol=1e-5, atol=1e-6)
    got = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    want_launches = dict.fromkeys(K.LAUNCHES, 0)
    want_launches.update(cluster_nearest=1, cluster_anyhit=5,
                         cluster_transmit=5)
    assert got == want_launches


@pytest.mark.parametrize("alphas", [(0.3, 0.85, 1.0), (1.0,), (0.5, 0.25)],
                         ids=["mixed", "opaque", "no-zero"])
def test_transmit_kernel_equal_plain_version(dev, alphas):
    """K7 against its plain version on alpha tables; where every alpha is
    1 the first crossing ends the walk (the product-0 exit)."""
    scene, o, d = _mesh(dev)
    cl = _alpha_table(scene.clusters, dev, alphas)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    for dist in (torch.full_like(rays[0], 100.0),
                 torch.full_like(rays[0], 2.0)):
        got = C.cluster_transmittance(cl, *rays, dist)
        want = C.cluster_transmittance_plain(cl, *rays, dist)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert bool((want < 1.0).any())
        if alphas == (1.0,):
            # every crossing ends the walk at 0: the product is exact
            assert bool(((want == 0.0) | (want == 1.0)).all())
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        if alphas == (0.5, 0.25):
            assert bool((got > 0.0).all())


def test_cluster_test_count(dev):
    scene, o, d = _mesh(dev, n_rays=256)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    n = o.shape[0]
    dense = n * scene.n_tris
    far = torch.full_like(rays[0], 4.0)
    for fn, args in ((C.cluster_intersect, rays),
                     (C.cluster_occluded, rays + [far]),
                     (C.cluster_transmittance, rays + [far])):
        tests = torch.zeros(1, dtype=torch.int64, device=dev)
        nodes = torch.zeros_like(tests)
        fn(scene.clusters, *args, test_count=tests, node_count=nodes)
        # the walk culls: fewer tests and node visits than the dense
        # n x 4,236 tests, at least one of each
        assert 0 < int(tests) < dense
        assert 0 < int(nodes) < dense


@pytest.mark.parametrize("opts,nearest,shadow", [
    (RenderOptions(spp=2, max_depth=3), 5, ("cluster_anyhit", 4)),
    (RenderOptions(spp=2, max_depth=3, mis=False), 4, ("cluster_anyhit", 4)),
    (RenderOptions(spp=2, max_depth=3, alpha_shadows=True), 5,
     ("cluster_transmit", 4))], ids=["mis", "nee-only", "alpha-shadows"])
def test_mesh_render_goes_through_the_cluster_kernels(dev, opts, nearest,
                                                      shadow):
    scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev)
    before = dict(K.LAUNCHES)
    img = render(scene, cam, opts, seed=1)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    got = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    want = dict.fromkeys(K.LAUNCHES, 0)
    want["cluster_nearest"] = nearest * opts.spp
    want[shadow[0]] = shadow[1] * opts.spp
    assert got == want


WALKS = {"nearest": C.cluster_intersect, "anyhit": C.cluster_occluded,
         "transmit": C.cluster_transmittance}


def _walk_args(dev, mode, n_rays=8192):
    scene, o, d = _mesh(dev, n_rays=n_rays)
    cl = scene.clusters
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    if mode == "nearest":
        return cl, rays
    t = C.cluster_intersect_plain(cl, *rays)[0]
    dist = torch.where(t < 3e38, t, 10.0) * 1.5
    return (_alpha_table(cl, dev) if mode == "transmit" else cl), \
        rays + [dist]


def _counted(fn, cl, args):
    tests = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    nodes = torch.zeros_like(tests)
    out = fn(cl, *args, test_count=tests, node_count=nodes)
    return out, int(tests), int(nodes)


@pytest.mark.parametrize("mode", sorted(WALKS))
def test_walk_counters_change_no_output(dev, mode):
    """K5/K6/K7 with their counters passed give bit-equal outputs to the
    same launch without them."""
    cl, args = _walk_args(dev, mode)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    uncounted = WALKS[mode](cl, *args)
    counted, tests, nodes = _counted(WALKS[mode], cl, args)
    if mode != "nearest":
        uncounted, counted = (uncounted,), (counted,)
    for u, c in zip(uncounted, counted):
        assert torch.equal(bits(u), bits(c))
    assert tests > 0 and nodes >= args[0].shape[0]


@pytest.mark.parametrize("mode", sorted(WALKS))
def test_warp_totals_equal_the_lanes_counts(dev, mode):
    """The warp-aggregated totals of one launch equal the sum of each
    lane's own count, taken by launching every ray alone (a lane's walk
    does not depend on its warp's other lanes), over a count of rays that
    leaves the last warp ragged."""
    cl, args = _walk_args(dev, mode, n_rays=4096)
    keep = torch.arange(0, args[0].shape[0], 37, device=dev)[:203]
    args = [a[keep].contiguous() for a in args]
    _, tests, nodes = _counted(WALKS[mode], cl, args)
    lanes = [_counted(WALKS[mode], cl, [a[i:i + 1].contiguous()
                                        for a in args])[1:]
             for i in range(args[0].shape[0])]
    assert (tests, nodes) == (sum(t for t, _ in lanes),
                              sum(v for _, v in lanes))
    assert nodes > len(lanes)


def _walk_spans():
    return [s for s in profiling.recorded()
            if s.name in ("isect.nearest", "isect.anyhit", "isect.transmit")]


@pytest.mark.parametrize("alpha", [False, True], ids=["anyhit", "transmit"])
def test_walk_counts_ride_the_spans_only_while_recording(dev, monkeypatch,
                                                         alpha):
    """A mesh render's cluster queries pass the walk's counters while
    spans record and carry them as ``visits`` and ``tests`` (every lane
    visits the root at least); with nothing recording no query passes
    them; a dense scene's spans carry none."""
    from tuturenderer_tpu_torch.integrators import path
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    monkeypatch.setattr(cuda_graph, "ON", False)
    passed = []
    for name in ("cluster_intersect", "cluster_occluded",
                 "cluster_transmittance"):
        def wrap(real):
            def call(*args, **kw):
                passed.append(kw.get("node_count") is not None)
                return real(*args, **kw)
            return call
        monkeypatch.setattr(TI, name, wrap(getattr(TI, name)))
    scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev)
    opts = RenderOptions(spp=2, max_depth=3, alpha_shadows=alpha)
    with profiling.recording():
        path.render(scene, cam, opts, 1)
    walks = _walk_spans()
    assert [s.name for s in walks].count(
        "isect.transmit" if alpha else "isect.anyhit") == 2 * 4
    assert len(walks) == 2 * 9 and passed == [True] * 18
    for s in walks:
        assert int(s.counts["visits"]) >= s.counts["lanes"] > 0
        assert int(s.counts["tests"]) > 0
    passed.clear()
    path.render(scene, cam, opts, 1)
    assert passed == [False] * 18 and len(_walk_spans()) == len(walks)
    box, bcam = simple_box(32, 24, device=dev)
    with profiling.recording():
        path.render(box, bcam, RenderOptions(spp=1, max_depth=3), 1)
    dense = _walk_spans()[len(walks):]
    assert len(dense) == 9 and not any("visits" in s.counts or "tests" in
                                       s.counts for s in dense)


def test_a_graph_replay_counts_no_walk(dev, monkeypatch):
    """The wavefront captured after a recorded (eager, counted) render
    holds no counter: replays record no span and add nothing to the
    counts the recorded spans hold, and their image is the eager one."""
    from tuturenderer_tpu_torch.integrators import path
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev)
    opts = RenderOptions(spp=2, max_depth=3)
    with profiling.recording():
        want = path.render(scene, cam, opts, 1)
    assert cuda_graph._CAPTURED[(id(scene), "path")].graph is not None
    walks = _walk_spans()
    counts = [(int(s.counts["visits"]), int(s.counts["tests"]))
              for s in walks]
    n_spans = len(profiling.recorded())
    replays = cuda_graph.REPLAYED["path"]
    got = [path.render(scene, cam, opts, 1) for _ in range(3)]
    torch.cuda.synchronize()
    assert cuda_graph.REPLAYED["path"] - replays == 3 * 2
    assert len(profiling.recorded()) == n_spans
    assert [(int(s.counts["visits"]), int(s.counts["tests"]))
            for s in walks] == counts
    for g in got:
        assert torch.equal(_bits(g), _bits(want))


def test_cluster_wrapper_raises_on_a_wrong_length_table(dev):
    """A table whose BVH rows (K5/K6/K7) or Woop rows (K7's alphas) are
    cut short raises before any launch."""
    scene, o, d = _mesh(dev, n_rays=64)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    dist = torch.ones_like(rays[0])
    cl = scene.clusters
    short_rows = dataclasses.replace(
        cl, bvh_rows=cl.bvh_rows[:-1].contiguous())
    short_woop = dataclasses.replace(cl, woop=cl.woop[:-1].contiguous())
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError):
        C.cluster_intersect(short_rows, *rays)
    with pytest.raises(ValueError):
        C.cluster_occluded(short_rows, *rays, dist)
    with pytest.raises(ValueError):
        C.cluster_transmittance(short_rows, *rays, dist)
    with pytest.raises(ValueError):
        C.cluster_transmittance(short_woop, *rays, dist)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("which", ["simple_box", "soup4095"])
def test_mt_kernels_equal_plain_versions(dev, which):
    scene, o, d = _box(dev) if which == "simple_box" else _soup(dev)
    table = K.pack_triangles(scene)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    before = dict(K.LAUNCHES)
    got = K.tri_intersect_mt(table, *rays)
    want = K.tri_intersect_mt_plain(table, *rays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert bool((want[1] >= 0).any())
    for scale in (0.5, 1.0, 2.0):
        dist = torch.where(want[1] >= 0, want[0], 1.0) * scale
        torch.testing.assert_close(
            K.tri_occluded_mt(table, *rays, dist),
            K.tri_occluded_mt_plain(table, *rays, dist))
    assert K.LAUNCHES["mt_nearest"] == before["mt_nearest"] + 1
    assert K.LAUNCHES["mt_anyhit"] == before["mt_anyhit"] + 3


@pytest.mark.parametrize("n_tris", [12, 300])
@pytest.mark.parametrize("n_rays", [1, 255, 257, 1001])
def test_mt_nearest_ragged_edges(dev, n_rays, n_tris):
    """K3 traces two rays per thread, 512 per block, against tiles of 256
    triangles: ray counts below, around and off a block, and a table with
    a partial second tile, bit-equal to the plain version."""
    scene, o, d = _soup(dev, n_tris=n_tris, n_rays=n_rays)
    table = K.pack_triangles(scene)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    got = K.tri_intersect_mt(table, *rays)
    want = K.tri_intersect_mt_plain(table, *rays)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mt_nearest_refuses_an_unaligned_table(dev):
    scene, o, d = _soup(dev, n_tris=12, n_rays=64)
    base = K.pack_triangles(scene)
    table = torch.cat([base.new_zeros(1), base])[1:]
    assert table.data_ptr() % 16 == 4
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        K.tri_intersect_mt(table, *rays)
    assert K.LAUNCHES == before


SHADOW_DISTS = ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                (1.0, -5e-5), (1.0, 2e-4), (1.0, -2e-4))


@pytest.mark.parametrize("n_tris", [1, 12, 255, 256, 257, 300, 4095])
@pytest.mark.parametrize("n_rays", [1, 255, 257, 511, 513, 1001])
def test_tiled_kernels_ragged_edges(dev, n_rays, n_tris):
    """K1 (Woop nearest hit), K2 (Woop any hit) and K4 (MT any hit) trace
    one or two rays per thread, 256 or 512 per block, against tiles of 256
    triangles: ray counts below, around and off a block, tables of one
    triangle, of a tile and around it, and of 16 tiles, bit-equal to the
    plain versions at shadow distances around each hit."""
    scene, o, d = _soup(dev, n_tris=n_tris, n_rays=n_rays)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    woop, mt = K.pack_triangles_woop(scene), K.pack_triangles(scene)
    before = dict(K.LAUNCHES)
    want = K.tri_intersect_plain(woop, *rays)
    for g, w in zip(K.tri_intersect(woop, *rays), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    t, idx, _, _ = K.tri_intersect_mt_plain(mt, *rays)
    t_ref = torch.where(idx >= 0, t, 10.0)
    for scale, off in SHADOW_DISTS:
        dist = t_ref * scale + off
        torch.testing.assert_close(K.tri_occluded_mt(mt, *rays, dist),
                                   K.tri_occluded_mt_plain(mt, *rays, dist))
        torch.testing.assert_close(K.tri_occluded(woop, *rays, dist),
                                   K.tri_occluded_plain(woop, *rays, dist))
    got = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    want_launches = dict.fromkeys(K.LAUNCHES, 0)
    want_launches.update(nearest=1, anyhit=len(SHADOW_DISTS),
                         mt_anyhit=len(SHADOW_DISTS))
    assert got == want_launches


def _block_exit_set(dev):
    """At 4,095 triangles (16 tiles): rays 0-511 aimed at the centroids of
    triangles 0-255 with no distance limit (blocked in the first tile),
    rays 512-1023 never blocked (dist 0, every tile), a range that mixes
    the two, rays 1536-2047 blocked again and a ragged mixed end."""
    scene, _, _ = _soup(dev, n_tris=4095, n_rays=1)
    verts = torch.stack([torch.stack(list(v), 1)
                         for v in (scene.tv0, scene.tv1, scene.tv2)], 1)
    r = np.random.RandomState(9)
    n = 4 * 512 + 100
    aim = torch.from_numpy(r.randint(0, 256, n)).to(dev)
    o = torch.from_numpy((r.randn(n, 3) * 8.0).astype(np.float32)).to(dev)
    d = verts[aim].mean(dim=1) - o
    d = d / d.norm(dim=1, keepdim=True)
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    dist = torch.full((n,), float("inf"), device=dev)
    dist[512:1024] = 0.0
    dist[1024 + 1:1536:2] = 0.0
    dist[2048 + 1::3] = 0.0
    return scene, rays, dist


def _check_block_exits(occ, occ_plain, table, rays, dist):
    want = occ_plain(table, *rays, dist)
    torch.testing.assert_close(occ(table, *rays, dist), want)
    assert bool(want[:512].all()) and not bool(want[512:1024].any())
    assert bool(want[1024:1536:2].all()) and bool(want[1536:2048].all())


def test_mt_anyhit_block_exits(dev):
    """K4's exits on the block-exit set: its blocks of 512 rays all
    blocked in the first tile leave after it; a block never blocked walks
    every tile; a block that mixes the two, and a ragged last block, walk
    on for their unblocked rays."""
    scene, rays, dist = _block_exit_set(dev)
    _check_block_exits(K.tri_occluded_mt, K.tri_occluded_mt_plain,
                       K.pack_triangles(scene), rays, dist)


def test_woop_anyhit_block_exits(dev):
    """K2's exits on the same set (K2's blocks hold 256 rays a ray per
    thread, 512 at two)."""
    scene, rays, dist = _block_exit_set(dev)
    _check_block_exits(K.tri_occluded, K.tri_occluded_plain,
                       K.pack_triangles_woop(scene), rays, dist)


def test_dense_kernels_on_special_rays(dev):
    """K1-K4 against their plain versions on rays at the arithmetic's edge
    cases (``torch_port_util.special_rays``: in-plane rays, det = +-0, inf
    and NaN values, subnormal products, exact t ties), bit-equal, and the
    any hits at distances around each hit, at inf and at NaN."""
    verts = special_verts()
    b = SceneBuilder()
    m = b.add_material()
    b.add_triangles(verts, None, None, m)
    scene = b.build(device=dev)
    o, d, _ = special_rays(verts)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
            for a in (o, d) for i in range(3)]
    forms = ((K.pack_triangles_woop, K.tri_intersect, K.tri_intersect_plain,
              K.tri_occluded, K.tri_occluded_plain),
             (K.pack_triangles, K.tri_intersect_mt, K.tri_intersect_mt_plain,
              K.tri_occluded_mt, K.tri_occluded_mt_plain))
    for pack, near, near_plain, occ, occ_plain in forms:
        table = pack(scene)
        want = near_plain(table, *rays)
        for g, w in zip(near(table, *rays), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        t = torch.where(want[1] >= 0, want[0], 2.0)
        for dist in (t * 0.5, t, t * 2.0, t + 5e-5, t - 5e-5, t + 1e-4,
                     t - 1e-4, torch.full_like(t, float("inf")),
                     torch.full_like(t, float("nan"))):
            torch.testing.assert_close(occ(table, *rays, dist),
                                       occ_plain(table, *rays, dist))


def test_woop_nearest_takes_an_unaligned_table(dev):
    """K1 stages its rows 4 bytes at a time: a Woop table at a 4-byte
    offset gives the aligned table's answers."""
    scene, o, d = _soup(dev, n_tris=300, n_rays=1001)
    base = K.pack_triangles_woop(scene)
    table = torch.cat([base.new_zeros(1), base])[1:]
    assert table.data_ptr() % 16 == 4
    rays = [a[:, i].contiguous() for a in (o, d) for i in range(3)]
    for g, w in zip(K.tri_intersect(table, *rays),
                    K.tri_intersect_plain(base, *rays)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _fwd_bwd(scene, cam, opts):
    leaves = [a.detach().clone().requires_grad_(True)
              for a in G.get_params(scene).leaves()]
    img = G.render_diff(G.MaterialParams.from_leaves(leaves), scene, cam,
                        opts, seed=1)
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    return img, [g for g in grads if g is not None]


@pytest.mark.parametrize("mesh", [False, True], ids=["dense-mt", "cluster"])
def test_render_diff_goes_through_the_kernels(dev, monkeypatch, mesh):
    """Forward and backward of the differentiable render: per sample batch
    the forward pass, the batch's recomputation and each bounce's
    recomputation launch the bounce kernels, and the epilogue's nearest
    hit runs in the first two: 3 (max_depth + 1) + 2 nearest and
    3 (max_depth + 1) shadow launches."""
    monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")
    if mesh:
        scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev)
        near, shadow = "cluster_nearest", "cluster_anyhit"
    else:
        scene, cam = simple_box(32, 24, device=dev)
        near, shadow = "mt_nearest", "mt_anyhit"
    opts = RenderOptions(spp=2, max_depth=3)
    before = dict(K.LAUNCHES)
    img, grads = _fwd_bwd(scene, cam, opts)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    got = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    want = dict.fromkeys(K.LAUNCHES, 0)
    want[near] = (3 * 4 + 2) * opts.spp
    want[shadow] = 3 * 4 * opts.spp
    assert got == want


@pytest.mark.parametrize("n_tiles", [1, 3, 65])
@pytest.mark.parametrize("name", ["early", "full", "special"])
def test_visit_walk_equals_plain_version(dev, name, n_tiles):
    """K8 (a tile as a cluster of CTAs) bit-equal to the plain walk, with
    dead lanes: every third lane of tile 0, tile 1 half dead ("special":
    wholly), the last tile wholly dead; at 1 tile, 3 and 65 (more CTAs
    than the card has SMs)."""
    a = P.scenario(name, 128, n_tiles)
    a["live"][:P.TILE:3] = 0.0
    if n_tiles > 1:
        a["live"][P.TILE:2 * P.TILE:2] = 0.0
        a["live"][(n_tiles - 1) * P.TILE:] = 0.0
    args = P.tensors(a, dev)
    before = K.LAUNCHES["proto_visit"]
    t, idx = P.run(*args, nc=128)
    tp, ip = P.run_plain(*args, nc=128)
    torch.testing.assert_close(t, tp, rtol=0, atol=0)
    torch.testing.assert_close(idx, ip, rtol=0, atol=0)
    if name != "special":
        P.check(name, t[:P.TILE], idx[:P.TILE])
    assert K.LAUNCHES["proto_visit"] == before + 1


def test_visit_walk_reports_its_sms(dev):
    """``sm_ids`` gives the SM of every CTA of a launch, each tile a
    cluster of CTAs."""
    args = P.tensors(P.scenario("early", 128, 64), dev)
    ids = P.sm_ids(args[0], args[1], args[2:9], args[9], 128, 64)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ids.shape[0] % 64 == 0 and ids.shape[0] >= 128
    assert bool((ids >= 0).all()) and bool((ids < n_sms).all())


# ------------------------------------ the light tracer, naive PT, compaction

def _launch_delta(before):
    return {k: v - before[k] for k, v in K.LAUNCHES.items() if
            v != before[k]}


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
@pytest.mark.parametrize("integrator", ["light", "naivept"])
def test_light_and_naive_go_through_the_kernels(dev, integrator, mesh):
    """Per sample, light tracing launches max(lt_max_depth, 2) - 1 nearest
    hits and one shadow call more (the direct splat); naive PT the nearest
    hits only."""
    from tuturenderer_tpu_torch.integrators import light, naive
    if mesh:
        scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev)
        near, occ = "cluster_nearest", "cluster_anyhit"
    else:
        scene, cam = simple_box(32, 24, device=dev)
        near, occ = "nearest", "anyhit"
    opts = RenderOptions(spp=3, lt_max_depth=4)
    mod = light if integrator == "light" else naive
    before = dict(K.LAUNCHES)
    img = mod.render(scene, cam, opts, 2)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    want = {near: 3 * 3}
    if integrator == "light":
        want[occ] = 3 * 4
    assert _launch_delta(before) == want


def _bdpt_scene(mesh: bool, device):
    if mesh:
        return sphere_showcase(32, 24, nu=46, nv=46, device=device), \
            ("cluster_nearest", "cluster_anyhit")
    return simple_box(32, 24, device=device), ("nearest", "anyhit")


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
def test_bdpt_goes_through_the_kernels(dev, mesh):
    """Per wavefront BDPT launches 2 bdpt_max_path_length - 1 nearest hits
    (the eye and the light walk) and one shadow call over every strategy's
    connection rays; the card's image agrees with the CPU's (the plain
    versions) on >= 99 % of pixels within rtol 1e-4 / atol 1e-5."""
    from tuturenderer_tpu_torch.integrators import bdpt
    (scene, cam), (near, occ) = _bdpt_scene(mesh, dev)
    opts = RenderOptions(spp=4, samples_per_launch=2, bdpt_max_path_length=4)
    before = dict(K.LAUNCHES)
    img = bdpt.render(scene, cam, opts, 3)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert _launch_delta(before) == {near: 2 * 7, occ: 2}
    (c_scene, c_cam), _ = _bdpt_scene(mesh, "cpu")
    want = bdpt.render(c_scene, c_cam, opts, 3).numpy()
    got = img.cpu().numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99 and want.mean() > 0.05


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
def test_bdpt_replays_its_wavefront_from_a_cuda_graph(dev, mesh, monkeypatch):
    """After a scene's first render, its wavefronts replay the captured
    graph: the images equal the eager ones (``cuda_graph.ON`` off) at two
    sample bases within rtol 1e-5 / atol 1e-6 (the splats' atomic adds),
    and the kernel and RNG launch counts of a replay are the eager
    wavefront's."""
    from tuturenderer_tpu_torch.integrators import bdpt
    (scene, cam), (near, occ) = _bdpt_scene(mesh, dev)
    opts = RenderOptions(spp=4, samples_per_launch=2, bdpt_max_path_length=4)
    bdpt.render(scene, cam, opts, 3)
    assert cuda_graph._CAPTURED[(id(scene), "bdpt")].graph is not None
    before, draws = dict(K.LAUNCHES), rng.LAUNCHES
    got = [bdpt.render(scene, cam, opts, 3, sample_base=b) for b in (0, 8)]
    replayed = _launch_delta(before), rng.LAUNCHES - draws
    monkeypatch.setattr(cuda_graph, "ON", False)
    before, draws = dict(K.LAUNCHES), rng.LAUNCHES
    want = [bdpt.render(scene, cam, opts, 3, sample_base=b) for b in (0, 8)]
    eager = _launch_delta(before), rng.LAUNCHES - draws
    assert replayed == eager and eager[0] == {near: 4 * 7, occ: 4}
    assert eager[1] > 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert not torch.equal(got[0], got[1])


def test_bdpt_runs_eagerly_while_spans_record(dev):
    """Under ``recording()`` a scene with a capture still renders eagerly,
    so its spans see the wavefront; the capture goes with its scene; and
    differentiable options never capture."""
    import gc
    from tuturenderer_tpu_torch.integrators import bdpt
    (scene, cam), _ = _bdpt_scene(True, dev)
    opts = RenderOptions(spp=2, samples_per_launch=2, bdpt_max_path_length=4)
    bdpt.render(scene, cam, opts, 3)
    key = (id(scene), "bdpt")
    assert cuda_graph._CAPTURED[key].graph is not None
    with profiling.recording():
        n0 = len(profiling.recorded())
        bdpt.render(scene, cam, opts, 3)
        names = [s.name for s in profiling.recorded()[n0:]]
    assert names.count("bdpt.connect") == 1 and names.count("render") == 1
    del scene
    gc.collect()
    assert key not in cuda_graph._CAPTURED
    (scene, cam), _ = _bdpt_scene(True, dev)
    bdpt.render(scene, cam, dataclasses.replace(opts, differentiable=True), 3)
    assert (id(scene), "bdpt") not in cuda_graph._CAPTURED


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
@pytest.mark.parametrize("sb", [1, 4])
def test_path_replays_its_wavefront_from_a_cuda_graph(dev, mesh, sb,
                                                      monkeypatch):
    """After a scene's first render, the path tracer's wavefronts replay
    the captured graph: with jitter on, at two sample bases and 1 or 4
    samples a wavefront, the images are bit-equal to the eager ones
    (``cuda_graph.ON`` off), the kernel and RNG launch counts of a replay
    are the eager wavefront's, and the counters tell replays from eager
    wavefronts."""
    from tuturenderer_tpu_torch.integrators import path
    scene, cam = sphere_showcase(32, 24, nu=46, nv=46, device=dev) if mesh \
        else simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=8, samples_per_launch=sb, max_depth=4,
                         jitter=True)
    path.render(scene, cam, opts, 3)
    assert cuda_graph._CAPTURED[(id(scene), "path")].graph is not None
    before, draws = dict(K.LAUNCHES), rng.LAUNCHES
    replays, eager = cuda_graph.REPLAYED["path"], cuda_graph.EAGER["path"]
    got = [path.render(scene, cam, opts, 3, sample_base=b) for b in (0, 8)]
    replayed = _launch_delta(before), rng.LAUNCHES - draws
    assert cuda_graph.REPLAYED["path"] - replays == 2 * 8 // sb
    assert cuda_graph.EAGER["path"] == eager
    monkeypatch.setattr(cuda_graph, "ON", False)
    before, draws = dict(K.LAUNCHES), rng.LAUNCHES
    want = [path.render(scene, cam, opts, 3, sample_base=b) for b in (0, 8)]
    eager_counts = _launch_delta(before), rng.LAUNCHES - draws
    assert cuda_graph.EAGER["path"] - eager == 2 * 8 // sb
    assert replayed == eager_counts and eager_counts[1] > 0
    assert sum(eager_counts[0].values()) == 2 * (8 // sb) * (6 + 5)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
def test_path_replays_compacted_wavefronts_bit_equal(dev, mesh,
                                                     monkeypatch):
    """Compacted options capture too: a replayed render under a schedule
    that overflows equals the eager one bit for bit, its overflow count
    included, and launches what it does."""
    from tuturenderer_tpu_torch.integrators import path
    scene, cam = sphere_showcase(64, 48, nu=46, nv=46, device=dev) if mesh \
        else simple_box(64, 48, device=dev)
    opts = RenderOptions(spp=4, samples_per_launch=2, max_depth=4,
                         compaction=(1.0, 0.5, 0.25))
    path.render(scene, cam, opts, 5)
    assert cuda_graph._CAPTURED[(id(scene), "path")].graph is not None
    before = dict(K.LAUNCHES)
    got, st = path.render(scene, cam, opts, 5, sample_base=4, stats=True)
    replayed = _launch_delta(before)
    monkeypatch.setattr(cuda_graph, "ON", False)
    before = dict(K.LAUNCHES)
    want, wst = path.render(scene, cam, opts, 5, sample_base=4, stats=True)
    assert replayed == _launch_delta(before)
    assert int(st["compaction_overflow"]) == \
        int(wst["compaction_overflow"]) > 0
    assert torch.equal(_bits(got), _bits(want))


def test_path_runs_eagerly_with_its_queries_rebound(dev, monkeypatch):
    """With ``intersect_core`` rebound (as the benchmark's traced-query
    count does), a scene with a capture renders eagerly, so the wrapper
    sees every query, and no capture of the wrapper is made; under
    ``recording()`` the spans see each wavefront; the capture goes with
    its scene."""
    import gc
    from tuturenderer_tpu_torch.integrators import path
    scene, cam = simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=2, max_depth=3)
    path.render(scene, cam, opts, 3)
    key = (id(scene), "path")
    cap = cuda_graph._CAPTURED[key]
    assert cap.graph is not None
    seen = []

    def counting(*args, **kw):
        seen.append(1)
        return real(*args, **kw)
    real = path.intersect_core
    monkeypatch.setattr(path, "intersect_core", counting)
    want = path.render(scene, cam, opts, 3)
    assert len(seen) == 2 * (3 + 2) and cuda_graph._CAPTURED[key] is cap
    monkeypatch.setattr(path, "intersect_core", real)
    torch.testing.assert_close(path.render(scene, cam, opts, 3), want,
                               rtol=0, atol=0)
    with profiling.recording():
        n0 = len(profiling.recorded())
        path.render(scene, cam, opts, 3)
        names = [s.name for s in profiling.recorded()[n0:]]
    assert names.count("render.sample") == 2
    del scene, cap
    gc.collect()
    assert key not in cuda_graph._CAPTURED


@pytest.mark.parametrize("renderer,near,occ", [
    ("render_light_diff", 1, 2), ("render_bdpt_diff", 7, 1)])
def test_light_and_bdpt_gradients_on_the_card(dev, renderer, near, occ):
    """Forward and backward of the light tracer's and BDPT's
    differentiable renders on the card: each sample is traced in the
    forward pass and once more in the backward (``near``/``occ`` launches a
    trace, lt_max_depth 2 and bdpt_max_path_length 4), and the gradients
    agree with the CPU's within 1e-3 of each leaf's largest magnitude."""
    fn = getattr(G, renderer)
    opts = RenderOptions(spp=2, bdpt_max_path_length=4)

    def fwd_bwd(device):
        scene, cam = simple_box(32, 24, device=device)
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in G.get_params(scene).leaves()]
        img = fn(G.MaterialParams.from_leaves(leaves), scene, cam, opts, 5)
        grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
        return img, [torch.zeros_like(a) if g is None else g
                     for a, g in zip(leaves, grads)]

    before = dict(K.LAUNCHES)
    img, grads = fwd_bwd(dev)
    assert _launch_delta(before) == {"nearest": 2 * 2 * near,
                                     "anyhit": 2 * 2 * occ}
    assert bool(torch.isfinite(img).all())
    _, want = fwd_bwd("cpu")
    for g, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale
    assert float(grads[0].abs().sum()) > 0.0


@pytest.mark.parametrize("mesh", [False, True], ids=["dense", "cluster"])
def test_compaction_on_the_card(dev, mesh):
    """A shrink launches no kernel: a compacted render launches what the
    uncompacted one does; the overflow count stays a device tensor; a
    roomy schedule gives the uncompacted image up to float order."""
    if mesh:
        scene, cam = sphere_showcase(64, 48, nu=46, nv=46, device=dev)
        opts = RenderOptions(spp=2, max_depth=3, alpha_shadows=True)
        want = {"cluster_nearest": 2 * 5, "cluster_transmit": 2 * 4}
    else:
        scene, cam = simple_box(64, 48, device=dev)
        opts = RenderOptions(spp=2, max_depth=3)
        want = {"nearest": 2 * 5, "anyhit": 2 * 4}
    plain = render(scene, cam, opts, seed=4)
    for sched, overflows in (((1.0, 0.25), True), ((1.0, 1.0), False),
                             ((1.0, 0.75), False)):
        before = dict(K.LAUNCHES)
        img, st = render(scene, cam, dataclasses.replace(
            opts, compaction=sched), seed=4, stats=True)
        assert _launch_delta(before) == want
        over = st["compaction_overflow"]
        assert over.device.type == "cuda" and over.dtype == torch.int32
        assert (int(over) > 0) == overflows, (sched, int(over))
        assert bool(torch.isfinite(img).all())
        if not overflows:
            torch.testing.assert_close(img, plain, rtol=1e-5, atol=1e-6)


def test_render_config_on_the_card(tmp_path):
    """render_config builds and renders on the card by default and hands
    back a numpy image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_port_util import golden_config
    from tuturenderer_tpu_torch.render import render_config
    path = golden_config("tex_128.txt", str(tmp_path), (32, 24))
    before = dict(K.LAUNCHES)
    img = render_config(path, RenderOptions(spp=2, max_depth=2),
                        verbose=False)
    assert isinstance(img, np.ndarray) and img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert _launch_delta(before) == {"nearest": 2 * 4, "anyhit": 2 * 3}


def test_non_finite_raster_is_outside_on_the_card(dev):
    """CUDA casts a NaN raster coordinate to 0, an accepted column; the
    port's world_to_pixel_index gives -1 for any non-finite one."""
    from tuturenderer_tpu_torch.camera import (importance_we, make_camera,
                                               world_to_pixel_index)
    from tuturenderer_tpu_torch.utils.vec import Vec3
    cam = make_camera(24, 20, 60, eye=(0, 0, -3.2), viewdir=(0, 0, 1),
                      updir=(0, 1, 0), device=dev)
    pts = Vec3(*(torch.tensor(c, device=dev) for c in
                 ([0.0, 0.5, 0.0], [0.0, 0.1, 0.0], [-3.2, -3.2, 0.0])))
    idx = world_to_pixel_index(cam, pts)
    assert idx[:2].tolist() == [-1, -1] and int(idx[2]) >= 0
    we, _ = importance_we(cam, pts)
    assert we[:2].tolist() == [0.0, 0.0]


# ------------------------------------------------------------ the RNG kernel

RNG_LANES = 1 << 20


def _bits(x):
    return x.view(torch.int32)


def _rng_keys(dev, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lane = torch.randint(0, 2**31 - 1, (RNG_LANES,), generator=g,
                         device=dev).to(dtype)
    lane[:3] = torch.tensor([0, 1, 2**31 - 1], device=dev)
    sample = torch.randint(0, 1 << 20, (RNG_LANES,), generator=g,
                           device=dev).to(dtype)
    seeds = torch.randint(0, 2**31 - 1, (RNG_LANES,), generator=g,
                          device=dev).to(dtype)
    return seeds, lane, sample


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed_as", ["int", "0-d", "column"])
def test_rng_kernel_equals_plain_hash(dev, dtype, seed_as):
    """Every purpose at 1,048,576 lanes: the kernel's bits equal the plain
    hash's, the seed a Python int, a 0-d CUDA tensor or a column, the
    bounce word a Python int and a column; one launch a draw."""
    seeds, lane, sample = _rng_keys(dev, dtype, seed=len(seed_as))
    seed = {"int": 2**31 - 1, "0-d": torch.tensor(-7, dtype=dtype,
                                                  device=dev),
            "column": seeds}[seed_as]
    bounce = (lane % 16).to(dtype)
    for purpose in range(12):
        before = rng.LAUNCHES
        got = rng.uniform(seed, lane, sample, purpose % 7, purpose)
        assert rng.LAUNCHES == before + 1
        want = rng.uniform_plain(seed, lane, sample, purpose % 7, purpose)
        assert got.dtype == torch.float32 and got.shape == (RNG_LANES,)
        assert torch.equal(_bits(got), _bits(want))
        got = rng.uniform(seed, lane, sample, bounce, purpose)
        want = rng.uniform_plain(seed, lane, sample, bounce, purpose)
        assert torch.equal(_bits(got), _bits(want))
    got = rng.uniform_simple(seed, lane, 3)
    assert torch.equal(_bits(got), _bits(rng.uniform_simple_plain(
        seed, lane, 3)))
    got = rng.uniform_simple(seed, lane, sample)
    assert torch.equal(_bits(got), _bits(rng.uniform_simple_plain(
        seed, lane, sample)))


def test_rng_kernel_odd_columns(dev):
    """Columns the kernel reads one lane at a time: a broadcast sample id
    (stride 0), a strided view, a view that starts off 16 bytes, ragged
    lengths, a 0-d draw and a contiguous 2-D one."""
    lane = torch.arange(-5000, 5000, dtype=torch.int32, device=dev) * 7919
    smp = torch.broadcast_to(torch.tensor(12, dtype=torch.int32,
                                          device=dev), (4093,))
    cases = [(lane[:4093], smp), (lane[::2], lane[1::2]),
             (lane[1:4094], lane[2:4095]), (lane[:1], lane[5:6]),
             (lane[:7], lane[9:16]),
             (torch.tensor(3, device=dev), torch.tensor(4, device=dev)),
             (lane[:6000].reshape(60, 100), lane[4000:].reshape(60, 100))]
    for a, b in cases:
        got = rng.uniform(9, a, b, 2, rng.RR)
        want = rng.uniform_plain(9, a, b, 2, rng.RR)
        assert got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = rng.LAUNCHES
    assert rng.uniform(1, empty, empty, 0, 0).shape == (0,)
    assert rng.LAUNCHES == before


def test_rng_draw_copies_nothing_to_the_card(dev):
    """One draw with the seed and bounce as Python ints is one kernel and
    no host-to-device copy in the profiler's trace (the plain hash makes
    three)."""
    from torch.profiler import ProfilerActivity, profile
    lane = torch.arange(RNG_LANES, dtype=torch.int32, device=dev)
    rng.uniform(5, lane, lane, 1, rng.BSDF_U0)
    torch.cuda.synchronize()

    def records(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return ([n for n in names if "HtoD" in n],
                [n for n in names if "rng_uniform_kernel" in n])

    before = rng.LAUNCHES
    copies, kernels = records(lambda: rng.uniform(5, lane, lane, 1,
                                                  rng.BSDF_U0))
    assert rng.LAUNCHES == before + 1
    assert copies == [] and len(kernels) == 1
    copies, _ = records(lambda: rng.uniform_plain(5, lane, lane, 1,
                                                  rng.BSDF_U0))
    assert len(copies) == 3


def test_rng_draw_captures_in_a_cuda_graph(dev):
    """A draw captures into a CUDA graph, which a sync or a host-to-device
    copy from pageable memory would break, and its replay redraws the
    same bits."""
    lane = torch.arange(RNG_LANES, dtype=torch.int32, device=dev)
    smp = torch.full((RNG_LANES,), 4, dtype=torch.int32, device=dev)
    rng.uniform(5, lane, smp, 2, rng.RR)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rng.uniform(5, lane, smp, 2, rng.RR)
    smp.fill_(6)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(rng.uniform_plain(5, lane, smp, 2,
                                                           rng.RR)))


def test_rng_kernel_raises_on_words_it_does_not_take(dev):
    lane = torch.arange(64, dtype=torch.int32, device=dev)
    bad = [(lane.to(torch.int16), "int32 and int64"),
           (torch.arange(64), "one CUDA device"),
           (lane[:32], "does not broadcast"),
           (lane[None, :], "does not broadcast"),
           (lane.float(), "int32 and int64"),
           (2.5, "ints and integer tensors")]
    before = rng.LAUNCHES
    for word, match in bad:
        with pytest.raises(ValueError, match=match):
            rng.uniform(1, lane, word, 0, rng.RR)
    assert rng.LAUNCHES == before


def test_render_draws_through_the_rng_kernel(dev, monkeypatch):
    """Every draw of a render on the card goes through the kernel: each
    ``rng`` span's ``kernel`` count equals its ``draws``, one launch a
    span; the image equals the plain hash's, bit for bit (rendered
    eagerly: a replay would run the kernel its capture saw)."""
    scene, cam = simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=2, max_depth=3, jitter=True)
    before = rng.LAUNCHES
    with profiling.recording():
        n0 = len(profiling.recorded())
        img = render(scene, cam, opts, seed=1)
        spans = [s for s in profiling.recorded()[n0:] if s.name == "rng"]
    assert spans and rng.LAUNCHES - before == len(spans)
    assert all(s.counts["kernel"] == s.counts["draws"] > 0 for s in spans)
    real = (rng.uniform, rng.uniform_simple)
    try:
        rng.uniform, rng.uniform_simple = (rng.uniform_plain,
                                           rng.uniform_simple_plain)
        monkeypatch.setattr(cuda_graph, "ON", False)
        plain = render(scene, cam, opts, seed=1)
    finally:
        rng.uniform, rng.uniform_simple = real
    assert torch.equal(_bits(img), _bits(plain))


# ------------------------------------------------------------ the BSDF kernel

BSDF_LANES = 100_003        # not a multiple of the kernel's 256-lane block


def _bsdf_inputs(dev, n=BSDF_LANES, seed=0, mtype=None):
    """(params, wi, wo, ng, ns, tir, (r0, r1, lottery)) on ``dev``: every
    material type and a value that is none (6), or ``mtype`` on every lane;
    a fifth of the wi the mirror of wo, so the delta branches fire, and wo
    on both sides of ns."""
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.utils.vec import Vec3, reflect
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda: torch.rand(n, generator=g, device=dev)

    def unit():
        v = torch.randn(3, n, generator=g, device=dev)
        return Vec3(*(v / v.norm(dim=0)))
    mt = torch.randint(0, 7, (n,), generator=g, device=dev,
                       dtype=torch.int32) if mtype is None else \
        torch.full((n,), mtype, dtype=torch.int32, device=dev)
    p = TM.MatParams(mtype=mt, diffuse=Vec3(r(), r(), r()),
                     specular=Vec3(r(), r(), r()),
                     emission=Vec3(r(), r(), r()), alpha=r(), eta=1.1 + r(),
                     roughness=0.05 + 0.95 * r(), metallic=r())
    ns = unit()
    ng = (ns + unit() * 0.3).normalized(1e-20)
    wo, wi = unit(), unit()
    mirror = torch.arange(n, device=dev) % 5 == 0
    wi = Vec3(*(torch.where(mirror, a, b) for a, b in
                zip(reflect(wo, ns).normalized(1e-20), wi)))
    return p, wi, wo, ng, ns, r() < 0.2, (r(), r(), r())


def _bsdf_equal(got, want):
    """Bit for bit: float columns as int32 words (NaNs too), bool columns
    as they are; Vec3s and tuples column by column."""
    if isinstance(got, tuple):
        return len(got) == len(want) and all(_bsdf_equal(a, b)
                                             for a, b in zip(got, want))
    if got.dtype == torch.bool:
        return got.dtype == want.dtype and torch.equal(got, want)
    return got.shape == want.shape and torch.equal(_bits(got), _bits(want))


BSDF_TYPE_SETS = [None, (0, 3), (1, 2, 4), (5,), ()]


@pytest.mark.parametrize("mtype", [None, 0, 1, 2, 3, 4, 5])
def test_bsdf_kernels_equal_plain_versions(dev, mtype):
    """Each kernel against its plain version, bit for bit, on every type
    (mixed, then each alone): adjoint and the TIR mask on and off, the GGX
    sample quirk on and off, type sets that leave a lane's type out, the
    scene eta as a 0-d tensor and as a Python float; one launch a call."""
    from tuturenderer_tpu_torch import materials as TM
    p, wi, wo, ng, ns, tir, (r0, r1, lot) = _bsdf_inputs(dev, mtype=mtype)
    eta0 = torch.tensor(1.0, device=dev)
    for types in BSDF_TYPE_SETS:
        for eta in (eta0, 1.3):
            for adjoint in (False, True):
                for t in (None, tir):
                    before = TM.LAUNCHES["eval"]
                    got = TM.bxdf_eval(p, wi, wo, ng, ns, eta, adjoint, t,
                                       types)
                    assert TM.LAUNCHES["eval"] == before + 1
                    assert _bsdf_equal(got, TM.bxdf_eval_plain(
                        p, wi, wo, ng, ns, eta, adjoint, t, types))
            for bug in (False, True):
                got = TM.bxdf_sample(p, wo, ns, r0, r1, lot, eta, bug, types)
                assert _bsdf_equal(got, TM.bxdf_sample_plain(
                    p, wo, ns, r0, r1, lot, eta, bug, types))
            for eta_mat in (None, p.eta * 0.9):
                got = TM.bxdf_pdf(p, wi, wo, ns, eta, eta_mat, types)
                assert _bsdf_equal(got, TM.bxdf_pdf_plain(
                    p, wi, wo, ns, eta, eta_mat, types))


def test_bsdf_kernels_take_odd_operands(dev):
    """Strided views, a broadcast (stride-0) column, an int64 type column,
    lengths of 1 and 255, and 0 lanes (no launch)."""
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.utils.vec import Vec3
    p, wi, wo, ng, ns, tir, (r0, r1, lot) = _bsdf_inputs(dev, n=2 * 4099,
                                                         seed=3)
    half = lambda v: Vec3(*(c[::2] for c in v))
    sp = TM.MatParams(*(half(f) if isinstance(f, Vec3) else f[::2]
                        for f in p))
    sp = sp._replace(mtype=sp.mtype.to(torch.int64),
                     eta=torch.broadcast_to(torch.tensor(1.4, device=dev),
                                            (4099,)))
    cases = [(sp, half(wi), half(wo), half(ng), half(ns), tir[::2],
              r0[::2], r1[1::2], lot[::2])]
    for m in (1, 255, 0):
        f = lambda v: Vec3(*(c[:m] for c in v))
        cases.append((TM.MatParams(*(f(x) if isinstance(x, Vec3) else x[:m]
                                     for x in p)), f(wi), f(wo), f(ng),
                      f(ns), tir[:m], r0[:m], r1[:m], lot[:m]))
    for q, a, b, g_, s_, t, u0, u1, u2 in cases:
        before = dict(TM.LAUNCHES)
        assert _bsdf_equal(TM.bxdf_eval(q, a, b, g_, s_, 1.0, tir=t),
                           TM.bxdf_eval_plain(q, a, b, g_, s_, 1.0, tir=t))
        assert _bsdf_equal(TM.bxdf_sample(q, b, s_, u0, u1, u2, 1.0),
                           TM.bxdf_sample_plain(q, b, s_, u0, u1, u2, 1.0))
        assert _bsdf_equal(TM.bxdf_pdf(q, a, b, s_, 1.0),
                           TM.bxdf_pdf_plain(q, a, b, s_, 1.0))
        launched = 0 if q.mtype.numel() == 0 else 1
        assert TM.LAUNCHES == {k: v + launched for k, v in before.items()}


def test_bsdf_kernels_capture_in_a_cuda_graph(dev):
    """The three calls capture into one CUDA graph; its replay on new
    inputs written in place equals the plain versions on them."""
    from tuturenderer_tpu_torch import materials as TM
    p, wi, wo, ng, ns, tir, (r0, r1, lot) = _bsdf_inputs(dev, seed=5)
    calls = lambda: (TM.bxdf_eval(p, wi, wo, ng, ns, 1.0, tir=tir),
                     TM.bxdf_sample(p, wo, ns, r0, r1, lot, 1.0),
                     TM.bxdf_pdf(p, wi, wo, ns, 1.0))
    calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    q, *new = _bsdf_inputs(dev, seed=6)
    for mine, theirs in zip((p, wi, wo, ng, ns, tir, (r0, r1, lot)),
                            (q, *new)):
        for a, b in zip(torch.utils._pytree.tree_leaves(mine),
                        torch.utils._pytree.tree_leaves(theirs)):
            a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    assert _bsdf_equal(out, (TM.bxdf_eval_plain(p, wi, wo, ng, ns, 1.0,
                                                tir=tir),
                             TM.bxdf_sample_plain(p, wo, ns, r0, r1, lot,
                                                  1.0),
                             TM.bxdf_pdf_plain(p, wi, wo, ns, 1.0)))


def test_bsdf_kernels_raise_on_operands_they_do_not_take(dev):
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.utils.vec import Vec3
    p, wi, wo, ng, ns, tir, _ = _bsdf_inputs(dev, n=64)
    bad = [(p, Vec3(wi.x.double(), wi.y, wi.z), "float32"),
           (p, Vec3(wi.x.cpu(), wi.y, wi.z), "one CUDA device"),
           (p, Vec3(wi.x[:32], wi.y, wi.z), "does not broadcast"),
           (p._replace(mtype=p.mtype.float()), wi, "int32")]
    before = dict(TM.LAUNCHES)
    for q, a, match in bad:
        with pytest.raises(ValueError, match=match):
            TM.bxdf_eval(q, a, wo, ng, ns, 1.0)
    with pytest.raises(ValueError, match="float32"):
        TM.bxdf_pdf(p, wi, wo, ns, 1.0, p.eta.double())
    # [8, 8] operands: contiguous ones are taken, a transposed one is not
    sq = lambda f: Vec3(*(c.reshape(8, 8) for c in f)) \
        if isinstance(f, Vec3) else f.reshape(8, 8)
    q = TM.MatParams(*map(sq, p))
    with pytest.raises(ValueError, match="contiguous"):
        TM.bxdf_eval(q._replace(eta=q.eta.t()), *map(sq, (wi, wo, ng, ns)),
                     1.0)
    assert TM.LAUNCHES == before
    assert _bsdf_equal(TM.bxdf_eval(q, *map(sq, (wi, wo, ng, ns)), 1.0),
                       TM.bxdf_eval_plain(q, *map(sq, (wi, wo, ng, ns)),
                                          1.0))


def test_bsdf_runs_plain_where_autograd_records(dev):
    """With grad enabled and an operand that requires grad nothing
    launches and the value is the plain version's; under no_grad the same
    call launches."""
    from tuturenderer_tpu_torch import materials as TM
    p, wi, wo, ng, ns, tir, _ = _bsdf_inputs(dev, n=4096)
    leaf = p.roughness.clone().requires_grad_(True)
    q = p._replace(roughness=leaf)
    before = dict(TM.LAUNCHES)
    with torch.enable_grad():
        f = TM.bxdf_eval(q, wi, wo, ng, ns, 1.0)
        pdf = TM.bxdf_pdf(q, wi, wo, ns, 1.0)
        (f.x.sum() + pdf.sum()).backward()
    assert TM.LAUNCHES == before and leaf.grad is not None
    with torch.no_grad():
        TM.bxdf_eval(q, wi, wo, ng, ns, 1.0)
    assert TM.LAUNCHES["eval"] == before["eval"] + 1


def test_render_shades_through_the_bsdf_kernels(dev):
    """A path-traced render of simple_box launches 2 evals, 1 sample and 2
    pdfs a bounce, eagerly and on replay; every ``shade.bsdf`` span of the
    BSDF's calls counts ``kernel`` 1; the image equals the plain BSDF's
    bit for bit."""
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.integrators import path
    scene, cam = simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=2, max_depth=3, jitter=True)
    bounces = 2 * (opts.max_depth + 1)
    want = {"eval": 2 * bounces, "sample": bounces, "pdf": 2 * bounces}
    for replay in (False, True):
        before = dict(TM.LAUNCHES)
        img = path.render(scene, cam, opts, seed=1)
        assert {k: v - before[k] for k, v in TM.LAUNCHES.items()} == want
        assert cuda_graph._CAPTURED[(id(scene), "path")].graph is not None
    with profiling.recording():
        n0 = len(profiling.recorded())
        assert torch.equal(_bits(path.render(scene, cam, opts, seed=1)),
                           _bits(img))
        spans = [s for s in profiling.recorded()[n0:]
                 if s.name == "shade.bsdf" and "kernel" in s.counts]
    assert len(spans) == sum(want.values())
    assert all(s.counts["kernel"] == 1 for s in spans)
    real = {k: getattr(path, k) for k in ("bxdf_eval", "bxdf_sample",
                                          "bxdf_pdf")}
    try:
        for k in real:
            setattr(path, k, getattr(TM, k + "_plain"))
        cuda_graph.ON = False
        plain = path.render(scene, cam, opts, seed=1)
    finally:
        cuda_graph.ON = True
        for k, f in real.items():
            setattr(path, k, f)
    assert torch.equal(_bits(img), _bits(plain))


def test_invert_step_equals_the_plain_bsdf(dev):
    """A material-inversion step on the card (its forward pass through the
    kernels, its backward replay on the plain versions) gives the loss and
    gradients of the same step with the plain versions bound in, bit for
    bit. Under deterministic algorithms: the material gathers' backward
    (``index_add_``) otherwise adds a million lanes into a few rows by
    atomics, in an order that changes from run to run."""
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.integrators import path
    scene, cam = simple_box(32, 24, device=dev)
    opts = RenderOptions(spp=2, max_depth=3, differentiable=True)
    target = path.render(scene, cam, dataclasses.replace(
        opts, differentiable=False), seed=7).detach()
    guess = G.MaterialParams.from_leaves(
        [t * 0.9 for t in G.get_params(scene).leaves()])

    def step():
        before = dict(TM.LAUNCHES)
        loss, grads = G.image_loss_and_grad(guess, target, scene, cam, opts,
                                            seed=3)
        return loss, grads, {k: v - before[k] for k, v in
                             TM.LAUNCHES.items()}
    real = {k: getattr(path, k) for k in ("bxdf_eval", "bxdf_sample",
                                          "bxdf_pdf")}
    torch.use_deterministic_algorithms(True)
    try:
        loss, grads, launched = step()
        for k in real:
            setattr(path, k, getattr(TM, k + "_plain"))
        p_loss, p_grads, p_launched = step()
    finally:
        torch.use_deterministic_algorithms(False)
        for k, f in real.items():
            setattr(path, k, f)
    assert launched["eval"] > 0
    assert p_launched == {"eval": 0, "sample": 0, "pdf": 0}
    assert torch.equal(_bits(loss), _bits(p_loss))
    for g, w in zip(torch.utils._pytree.tree_leaves(grads),
                    torch.utils._pytree.tree_leaves(p_grads)):
        assert torch.equal(_bits(g), _bits(w))
