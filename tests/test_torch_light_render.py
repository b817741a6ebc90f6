"""Whole light-tracing renders of the PyTorch port against the JAX
package's, which ``tests/data/make_torch_integrator_refs.py`` stores for
chip_smoke.py: simple_box at 24x20 (both fed the scene tables JAX builds,
the JAX side through its dense Pallas kernels in interpret mode) and
sphere_showcase(24, 20, nu=46, nv=46), 4,236 triangles with cluster
tables, built by each package (the JAX side on its CPU route, its XLA BVH;
the port's cluster wrappers run their plain versions on the CPU), with
lt_max_depth 4; and the port form of test_integrators.py's light-tracing
case.

Tolerance: >= 99 % of pixels within rtol 1e-4 / atol 1e-5 and the image
mean within 0.5 % (a threshold compare can flip on a 1-ulp difference of a
transcendental and send a path elsewhere).
"""
import numpy as np
import pytest
import torch

from torch_port_util import (INTEGRATOR_CASES, INTEGRATOR_REFS, REF_SEED,
                             REF_SIZE, SHOWCASE_NU, SHOWCASE_NV, flatten,
                             integrator_fields, jax_integrator_render)
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.integrators import light as PL
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import scene_from_numpy

W, H = REF_SIZE


def _port_scene(kind: str):
    if kind == "showcase":
        return sphere_showcase(W, H, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                               device="cpu")
    from tuturenderer_tpu.scene.presets import simple_box
    scene, cam = simple_box(W, H)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


@pytest.fixture(scope="module", params=["lt-box", "lt-showcase"])
def jax_render(request):
    return request.param, jax_integrator_render(request.param)["image"]


def test_stored_light_reference_is_the_jax_render(jax_render):
    """chip_smoke.py holds the card's renders against these."""
    name, img = jax_render
    np.testing.assert_array_equal(np.load(INTEGRATOR_REFS[name])["image"],
                                  img)


def test_render_matches_jax(jax_render):
    """The showcase through the cluster kernels' plain versions on the
    CPU."""
    name, want = jax_render
    kind = INTEGRATOR_CASES[name][1]
    scene, cam = _port_scene(kind)
    assert (scene.clusters is not None) == (kind == "showcase")
    img = PL.render(scene, cam, RenderOptions(**integrator_fields(name)),
                    REF_SEED)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    img = img.numpy()
    assert np.isfinite(img).all() and want.mean() > 0.05
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - want.mean()) <= 0.005 * want.mean()


def test_light_tracing_renders_scene():
    """The port form of test_integrators.py's case, on its diffuse box."""
    from test_grad import diffuse_box
    j_scene, j_cam = diffuse_box(48)
    scene = scene_from_numpy(flatten(j_scene), device="cpu")
    cam = camera_from_numpy(flatten(j_cam), device="cpu")
    img = PL.render(scene, cam, RenderOptions(spp=16, lt_max_depth=3),
                    4).numpy()
    assert np.isfinite(img).all()
    assert (img.sum(-1) > 0).mean() > 0.3
    assert img.mean() > 0.01
