"""The naive path tracer (``integrators/naive.py``) of the PyTorch port
against the JAX package: one sample's radiance lane by lane and whole
renders on simple_box at 24x20 (both fed the scene tables JAX builds, the
JAX side through its dense Pallas kernels in interpret mode) and on
sphere_showcase(24, 20, nu=46, nv=46), 4,236 triangles with cluster
tables, built by each package (the JAX side on its CPU route, its XLA
BVH), with lt_max_depth 4 (its light is out of view, so a 2-vertex walk
renders black); the renders are the ones
``tests/data/make_torch_integrator_refs.py`` stores for chip_smoke.py.
Then the port forms of test_integrators.py's naive-vs-PT direct-light case
and of test_nee.py's mirror case.

Tolerances: per lane, rtol 1e-4 / atol 1e-5 on every lane; images, >= 99 %
of pixels within rtol 1e-4 / atol 1e-5 and the mean within 0.5 % (a
threshold compare can flip on a 1-ulp difference of a transcendental).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (INTEGRATOR_CASES, INTEGRATOR_REFS, REF_SEED,
                             REF_SIZE, SHOWCASE_NU, SHOWCASE_NV, flatten,
                             integrator_fields, jax_dense_pallas_interpret,
                             jax_integrator_render)
from tuturenderer_tpu.integrators import naive as JN
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu_torch.camera import camera_from_numpy, make_camera
from tuturenderer_tpu_torch.integrators import naive as PN
from tuturenderer_tpu_torch.integrators.path import render as path_render
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import (LAMBERTIAN,
                                               PERFECT_REFLECTIVE,
                                               SceneBuilder,
                                               scene_from_numpy)

W, H = REF_SIZE
SAMPLE = 1


def _assert_image_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


@pytest.fixture(scope="module")
def box():
    """(JAX per-lane radiance of one sample, port scene, port camera)."""
    scene, cam = j_simple_box(W, H)
    lane = jnp.arange(W * H, dtype=jnp.int32)
    with jax_dense_pallas_interpret():
        L = jax.jit(lambda: JN.trace_sample(
            scene, cam, lane % W, lane // W, lane, SAMPLE, REF_SEED,
            JOptions(lt_max_depth=4)))()
    return np.stack([np.asarray(c) for c in L], -1), \
        scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


def test_trace_sample_per_lane_matches_jax(box):
    want, scene, cam = box
    lane = torch.arange(W * H, dtype=torch.int32)
    L = PN.trace_sample(scene, cam, lane % W, lane // W, lane, SAMPLE,
                        REF_SEED, RenderOptions(lt_max_depth=4))
    got = L.stack().numpy()
    assert (want.sum(-1) > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=["naive-box", "naive-showcase"])
def jax_render(request):
    return request.param, jax_integrator_render(request.param)["image"]


def test_stored_naive_reference_is_the_jax_render(jax_render):
    """chip_smoke.py holds the card's renders against these."""
    name, img = jax_render
    np.testing.assert_array_equal(np.load(INTEGRATOR_REFS[name])["image"],
                                  img)


def test_render_matches_jax(jax_render, box):
    name, want = jax_render
    if INTEGRATOR_CASES[name][1] == "showcase":
        scene, cam = sphere_showcase(W, H, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                                     device="cpu")
        assert scene.clusters is not None
    else:
        scene, cam = box[1:]
    img = PN.render(scene, cam, RenderOptions(**integrator_fields(name)),
                    REF_SEED)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert want.mean() > 0.05
    _assert_image_close(img.numpy(), want)


def test_nan_sample_counts_as_zero(box, monkeypatch):
    """NaN rejection goes per sample: a sample whose radiance has a NaN
    channel adds 0, the other samples count as they are."""
    _, scene, cam = box
    opts = RenderOptions(spp=3)
    clean = [PN.trace_sample(scene, cam, *_lanes(), s, 2, opts).stack()
             for s in range(3)]
    real = PN.trace_sample

    def poisoned(scene, cam, px, py, lane, sample_idx, seed, opts):
        L = real(scene, cam, px, py, lane, sample_idx, seed, opts)
        if sample_idx == 1:
            return L._replace(y=torch.where(lane % 2 == 0, float("nan"),
                                            L.y))
        return L

    monkeypatch.setattr(PN, "trace_sample", poisoned)
    img = PN.render(scene, cam, opts, 2).reshape(-1, 3)
    even = torch.arange(W * H) % 2 == 0
    want = torch.where(even[:, None], clean[0] + clean[2],
                       clean[0] + clean[1] + clean[2]) / 3.0
    torch.testing.assert_close(img, want, rtol=1e-6, atol=1e-7)


def _lanes():
    lane = torch.arange(W * H, dtype=torch.int32)
    return lane % W, lane // W, lane


def test_pt_vs_naive_direct_light():
    """The port form of test_integrators.py's case: with a 2-vertex walk
    naive PT sees exactly the directly visible emitter, and PT's direct
    term agrees on those pixels."""
    from test_grad import diffuse_box
    j_scene, j_cam = diffuse_box(48)
    scene = scene_from_numpy(flatten(j_scene), device="cpu")
    cam = camera_from_numpy(flatten(j_cam), device="cpu")
    nv = PN.render(scene, cam, RenderOptions(spp=4, lt_max_depth=2),
                   3).numpy()
    pt = path_render(scene, cam, RenderOptions(spp=4, max_depth=0),
                     3).numpy()
    light_pixels = nv[..., 0] > 1.0
    assert light_pixels.sum() > 10
    np.testing.assert_allclose(nv[light_pixels], pt[light_pixels], rtol=0.05)


def test_naive_sees_the_mirrored_emitter_the_nee_estimator_cannot():
    """The port form of test_nee.py's mirror case from the BSDF-only side:
    a 45-degree mirror reflects an overhead light into the camera. The
    naive walk reaches the light through the mirror (a 3-vertex walk), the
    NEE-only path tracer's calcForMirror recursion returns 0 there, and the
    MIS path tracer pays it through the delta BSDF strategy."""
    b = SceneBuilder()
    mirror = b.add_material(PERFECT_REFLECTIVE)
    light = b.add_material(LAMBERTIAN, diffuse=(0.7, 0.7, 0.7),
                           emission=(20.0, 20.0, 20.0))

    def quad(p0, p1, p2, p3, mat):
        b.add_triangles(np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32),
                        None, None, mat)

    quad((-0.8, 0.8, 0.8), (0.8, 0.8, 0.8), (0.8, -0.8, -0.8),
         (-0.8, -0.8, -0.8), mirror)
    quad((-1.0, 2.0, -1.0), (1.0, 2.0, -1.0), (1.0, 2.0, 1.0),
         (-1.0, 2.0, 1.0), light)
    scene = b.build(device="cpu")
    cam = make_camera(24, 24, 30, eye=(0, 0, -3.0), viewdir=(0, 0, 1),
                      updir=(0, 1, 0), device="cpu")
    mis = path_render(scene, cam, RenderOptions(spp=2, max_depth=3), 0)
    nee = path_render(scene, cam,
                      RenderOptions(spp=2, max_depth=3, mis=False), 0)
    naive = PN.render(scene, cam, RenderOptions(spp=2, lt_max_depth=3), 0)
    bright = mis[..., 0] > 5.0
    assert bright.sum() > 20
    assert float(nee[..., 0][bright].max()) == 0.0
    assert float(naive[..., 0][bright].min()) > 1.0
    # a 2-vertex walk stops at the mirror
    short = PN.render(scene, cam, RenderOptions(spp=2, lt_max_depth=2), 0)
    assert float(short[..., 0][bright].max()) == 0.0
