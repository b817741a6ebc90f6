"""Wavefront compaction: the port forms of the three contracts of
``tests/test_intersect.py`` (there on cornell_box, whose OBJ assets this
checkout lacks), here on simple_box(64, 64), each run on both packages
(the JAX side on its own CPU route). 4,096 lanes: a width fraction of 0.25
or 0.1 really shrinks the wavefront (widths round up to 1,024 lanes).

- batching spp into one wavefront changes nothing: rtol 1e-5 / atol 1e-7,
  the JAX test's bar;
- an undersized buffer loses no energy: the overflow roulette keeps a
  random subset upweighted, so the mean matches the uncompacted render
  within 5 % (the JAX test's bar) at 8 spp, as many samples as its 32x32
  x 32 spp;
- the overflow count comes back on the device: > 0 for a tight schedule,
  0 for a roomy one.

The three share their renders (8 spp, max_depth 3, seed 3; the tight
schedule is (1.0, 0.25)), each made once per package.

Also here: the schedule's widths and segments, and that a shrink keeps
the lane and sample keys with their lanes.
"""
import numpy as np
import pytest
import torch

from tuturenderer_tpu.integrators.path import render as j_render
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu_torch.camera import primary_ray
from tuturenderer_tpu_torch.integrators import path as P
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.presets import simple_box

PACKAGES = ["jax", "port"]


BASE = dict(spp=8, max_depth=3)
TIGHT = (1.0, 0.25)


@pytest.fixture(scope="module")
def scenes():
    return {"jax": j_simple_box(64, 64),
            "port": simple_box(64, 64, device="cpu")}


@pytest.fixture(scope="module")
def renders(scenes):
    """render(pkg, **fields) -> (image numpy, overflow count) of
    simple_box(64, 64) at seed 3, each distinct render made once."""
    done = {}

    def render(pkg, **fields):
        key = (pkg, tuple(sorted(fields.items())))
        if key not in done:
            scene, cam = scenes[pkg]
            if pkg == "jax":
                img, st = j_render(scene, cam, JOptions(**fields), 3,
                                   stats=True)
            else:
                img, st = P.render(scene, cam, RenderOptions(**fields), 3,
                                   stats=True)
            done[key] = np.asarray(img), int(st["compaction_overflow"])
        return done[key]
    return render


@pytest.mark.parametrize("pkg", PACKAGES)
def test_batched_spp_render_matches_unbatched(renders, pkg):
    a, _ = renders(pkg, **BASE)
    b, _ = renders(pkg, **BASE, samples_per_launch=BASE["spp"])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compaction_overflow_is_unbiased_not_silent_drop(renders, pkg):
    a, over_a = renders(pkg, **BASE)
    b, over = renders(pkg, **BASE, compaction=TIGHT)
    assert over_a == 0 and over > 0 and np.isfinite(b).all()
    assert abs(b.mean() - a.mean()) / a.mean() < 0.05, (a.mean(), b.mean())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_compaction_overflow_count_surfaces_on_device(renders, pkg):
    img, over = renders(pkg, **BASE, compaction=TIGHT)
    assert over > 0 and np.isfinite(img).all()
    _, over0 = renders(pkg, **BASE, compaction=(1.0, 1.0))
    assert over0 == 0


def test_port_overflow_count_is_a_device_tensor(scenes):
    scene, cam = scenes["port"]
    img, st = P.render(scene, cam, RenderOptions(spp=1, max_depth=2,
                                                 compaction=(1.0, 0.1)), 3,
                       stats=True)
    over = st["compaction_overflow"]
    assert isinstance(over, torch.Tensor) and over.ndim == 0
    assert over.dtype == torch.int32 and over.device == img.device
    # without compaction the count is 0; stats=False returns the image
    plain = RenderOptions(spp=1, max_depth=2)
    img0, st0 = P.render(scene, cam, plain, 3, stats=True)
    assert int(st0["compaction_overflow"]) == 0
    torch.testing.assert_close(P.render(scene, cam, plain, 3), img0,
                               rtol=0, atol=0)


def test_schedule_widths_and_segments():
    assert P.seg_width(4096, 1.0) == 4096
    assert P.seg_width(4096, 0.25) == 1024
    assert P.seg_width(4096, 0.1) == 1024         # 409.6 -> 1,024 lanes
    assert P.seg_width(5120, 0.25) == 2048        # 1,280 -> 2,048
    assert P.seg_width(480, 0.5) == 480           # never wider than n
    opts = RenderOptions(max_depth=4, compaction=(1.0, 0.5, 0.5, 0.25))
    assert P._segments(opts) == [(1.0, [0]), (0.5, [1, 2]),
                                 (0.25, [3, 4])]


def test_shrink_keeps_each_lane_with_its_keys(scenes):
    """After a shrink the state's lane, sample and film keys ride with
    their lanes: the kept lanes are the live ones in roulette-key order,
    and their draws are keyed by their own (lane, sample)."""
    from tuturenderer_tpu_torch.utils import rng
    scene, cam = scenes["port"]
    n = cam.n_pixels
    lane = torch.arange(n, dtype=torch.int32)
    o, d, _ = primary_ray(cam, lane % 64, lane // 64)
    st = dict(o=o, d=d, L=P._zeros3(n, "cpu"),
              alive=(lane % 3) != 0, w=P._ones3(n, "cpu"),
              **P._lane_keys(lane.flip(0), torch.full((n,), 5,
                                                      dtype=torch.int32)))
    st["L"] = st["L"]._replace(x=lane.to(torch.float32))
    film = torch.zeros((n, 3))
    new, film, over = P._compact(st, film, 1024, 2, seed=9)
    assert int(over) == int(st["alive"].sum()) - 1024
    key = torch.where(st["alive"], rng.uniform(9, st["lane"], st["smp"], 2,
                                               rng.COMPACT), 2.0)
    keep = torch.argsort(key, stable=True)[:1024]
    assert torch.equal(new["fkey"], keep.to(torch.int32))
    assert torch.equal(new["lane"], st["lane"][keep])
    assert bool(new["alive"].all())
    # every lane's radiance went to its film slot; the kept ones restart
    torch.testing.assert_close(film[:, 0], lane.to(torch.float32))
    assert float(new["L"].x.abs().sum()) == 0.0
    factor = int(st["alive"].sum()) / 1024
    torch.testing.assert_close(new["w"].x, torch.full((1024,), factor))
