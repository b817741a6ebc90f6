"""``tuturenderer_tpu_torch/tools/time_kernels.py`` on the CPU: the parts
that are not timing. Its bounce-wavefront capture hands the cluster
kernels' inputs over unchanged, its alpha table changes the alphas of the
real rows alone, its capture of chosen kernel calls takes the calls its
picks name and changes no render, and without a card it refuses to
run."""
import numpy as np
import pytest
import torch

from torch_port_util import SHOWCASE_NU, SHOWCASE_NV
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.ops.cuda import cluster as C
from tuturenderer_tpu_torch.tools import time_kernels as TK


def test_refuses_to_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        TK.main([])


def test_wavefront_and_alpha_table():
    scene, cam = sphere_showcase(24, 20, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                                 device="cpu")
    cl = scene.clusters
    near, occ = TK.wavefront(scene, cam)
    assert len(near) == 6 and len(occ) == 7
    n = cam.n_pixels
    assert all(c.shape == (n,) and c.dtype == torch.float32
               for c in near + occ)
    # the depth-1 rays leave the camera's hits: live lanes hit something
    _, idx, _, _ = C.cluster_intersect(cl, *near)
    assert bool((idx >= 0).any())

    alpha_cl = TK.alpha_table(cl, "cpu")
    rows, _ = C.real_rows(alpha_cl)
    assert set(np.unique(rows[:, 13].numpy())) == \
        {np.float32(0.3), np.float32(0.85), np.float32(1.0)}
    # nothing but slot 13 of the rows changed, and the BVH is shared
    old, new = cl.woop.reshape(-1), alpha_cl.woop.reshape(-1)
    slot = torch.zeros(cl.woop.shape[0], 8 * 128, dtype=torch.bool)
    slot[:, 13:64 * 14:14] = True
    assert bool((old[~slot.reshape(-1)] == new[~slot.reshape(-1)]).all())
    assert alpha_cl.bvh_rows is cl.bvh_rows
    trans = C.cluster_transmittance(alpha_cl, *occ)
    assert bool((trans < 1.0).any()) and bool((trans > 0.0).any())


def test_capture_takes_the_picked_calls_and_changes_no_render():
    """simple_box(64, 64) under compaction (1.0, 0.25): 4,096 camera rays,
    then 1,024-lane wavefronts. The picks take the camera rays and the
    first shrunk calls; the render and its launches are those of a render
    without the capture; the wrappers are restored; a pick that matches
    no call raises."""
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.ops import intersect as I
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    scene, cam = simple_box(64, 64, device="cpu")
    opts = RenderOptions(spp=1, compaction=(1.0, 0.25))
    orig = (I.tri_intersect, I.tri_occluded)

    def counted(fn):
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        return fn(), dict(LAUNCHES)

    want, want_n = counted(lambda: render(scene, cam, opts, 0))
    with TK.capture(tri_intersect={"camera": TK.at(0),
                                   "shrunk": TK.first_shrunk},
                    tri_occluded={"shrunk": TK.first_shrunk}) as got:
        img, n = counted(lambda: render(scene, cam, opts, 0))
    assert torch.equal(img, want) and n == want_n
    assert (I.tri_intersect, I.tri_occluded) == orig
    table, cam_rays = got["tri_intersect"]["camera"]
    assert len(cam_rays) == 6 and cam_rays[0].shape == (4096,)
    assert torch.equal(table, I.pack_triangles_woop(scene))
    assert got["tri_intersect"]["shrunk"][1][0].shape == (1024,)
    shadow = got["tri_occluded"]["shrunk"][1]
    assert len(shadow) == 7 and shadow[6].shape == (1024,)
    with pytest.raises(RuntimeError, match="no call matched"):
        with TK.capture(tri_intersect={"none": TK.at(99)}):
            render(scene, cam, opts, 0)
    assert (I.tri_intersect, I.tri_occluded) == orig


@pytest.mark.parametrize("form", ["woop", "mt"])
def test_anyhit_tests_count_up_to_the_first_blocker(form):
    """The any hit's data-dependent work: per ray, the tests a serial loop
    makes up to and including its first blocker, or every triangle, in
    chunks of rays."""
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    scene = TK.soup(40, "cpu", seed=3)
    gen = torch.Generator().manual_seed(5)
    o = torch.randn((300, 3), generator=gen) * 3.0
    d = TK._unit(300, gen, "cpu")
    rays = TK._cols(o) + TK._cols(d)
    pack, occ, tile, floats = (
        (K.pack_triangles_woop, K.tri_occluded_plain, K._woop_tile, 13)
        if form == "woop" else
        (K.pack_triangles, K.tri_occluded_mt_plain, K._mt_tile, 12))
    table = pack(scene)
    dist = torch.full((300,), 8.0)
    want = 0
    for i in range(300):
        ray = [c[i:i + 1] for c in rays]
        for k in range(40):
            if occ(table[k * floats:(k + 1) * floats], *ray, dist[i:i + 1]):
                want += k + 1
                break
        else:
            want += 40
    assert 300 < want < 300 * 40
    assert TK.anyhit_tests(tile, floats, table, rays, dist, chunk=64) == want


def test_visit_checksums_and_plane_tests():
    """K8's timed scenarios at a small size on the CPU: the checksum (sum
    of t over hits, count of idx >= 0) of the plain walk, and the plane
    tests of the valid clusters of the groups each tile walks."""
    from tuturenderer_tpu_torch.tools import proto_visit as P
    calls = TK.visit_calls("cpu", nc=8, n_tiles=2)
    assert sorted(calls) == [("K8", "early 2 x 8"), ("K8", "full 2 x 8")]
    per_cluster = P.CS * P.TILE
    for (_, shape), (_, check, tests, args) in calls.items():
        out = P.run_plain(*args, nc=8)
        if shape.startswith("full"):
            # every ray hits z = 5 at t = 6; both tiles walk both groups
            assert check(out) == [6.0 * 2048, 2048]
            assert tests == 2 * 8 * per_cluster
        else:
            # t = 1 at cluster 0; each tile walks its first group
            assert check(out) == [1.0 * 2048, 2048]
            assert tests == 2 * 4 * per_cluster
    # the special planes skip their sentinel entries: tile 0 walks three
    # groups with two of them, dead tile 1 one group with one
    args = P.tensors(P.scenario("special", 16, 2), "cpu")
    _, _, groups = P.walk_plain(*args, nc=16)
    assert groups.tolist() == [3, 1]
    assert TK.visit_tests(args[1], groups, 16) == (10 + 3) * per_cluster


def test_sass_counts():
    """Instructions, FCHK and CALL per kernel of a cuobjdump listing."""
    listing = """
        Function : _Z3fooPf
        .headerflags    @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MUFU.RCP R3, R2 ;    /* 0x0000000200037308 */
                                                        /* 0x000e220000001000 */
        /*0010*/                   FCHK P0, R0, R2 ;    /* 0x0000000200007302 */
        /*0020*/              @!P0 BRA 0x60 ;           /* 0x0000000000008947 */
        /*0030*/                   CALL.REL.NOINC 0x80 ; /* 0x0000004000007944 */
        Function : _Z3barv
        /*0000*/                   EXIT ;               /* 0x000000000000794d */
"""
    assert TK.sass_counts(listing) == {"_Z3fooPf": (4, 1, 1),
                                       "_Z3barv": (1, 0, 0)}

