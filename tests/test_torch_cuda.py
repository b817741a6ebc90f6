"""The port's CUDA kernels on the card; every test here skips without a CUDA
device. This file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact. The kernels are built with --fmad=false and compute the
plain versions' float32 expressions in the same order.
"""
import numpy as np
import pytest
import torch

from tuturenderer_tpu_torch.camera import primary_ray
from tuturenderer_tpu_torch.integrators.path import render
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import SceneBuilder
from tuturenderer_tpu_torch.scene.presets import simple_box

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
