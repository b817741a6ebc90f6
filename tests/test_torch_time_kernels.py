"""``tuturenderer_tpu_torch/tools/time_kernels.py`` on the CPU: the parts
that are not timing. Its bounce-wavefront capture hands the cluster
kernels' inputs over unchanged, its alpha table changes the alphas of the
real rows alone, and without a card it refuses to run."""
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
