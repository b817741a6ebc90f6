"""The light tracer (``integrators/light.py``) and the camera's raster
functions of the PyTorch port against the JAX package on simple_box at
24x20, both fed the scene tables JAX builds, the JAX side through its dense
Pallas kernels in interpret mode: one sample's light paths lane by lane,
the raw accumulators of a chunk and their composition, the CHECK_LT pass
and the camera's raster chain (``test_torch_light_render.py`` holds whole
renders to the stored JAX renders).

Tolerances:

- per lane (one light path per lane): every splat index exact, and the
  splatted rgb within rtol 1e-4 / atol 1e-5;
- films: >= 99 % of pixels within rtol 1e-4 / atol 1e-5 and the mean
  within 0.5 % (a threshold compare can flip on a 1-ulp difference of a
  transcendental and send a path elsewhere);
- the raster functions: the float raster coordinates within rtol 1e-6,
  the pixel indices exact, We within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (REF_SEED, REF_SIZE, REF_SPP, flatten,
                             jax_dense_pallas_interpret)
from tuturenderer_tpu import camera as JC
from tuturenderer_tpu.integrators import light as JL
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch import camera as PC
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.integrators import light as PL
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.utils.vec import Vec3

W, H = REF_SIZE
SAMPLE = 1


def _assert_image_close(got, want):
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


@pytest.fixture(scope="module")
def jax_box():
    """The JAX side on simple_box: one sample's light paths per lane, the
    raw accumulators of a chunk, and the CHECK_LT pass."""
    scene, cam = j_simple_box(W, H)
    lane = jnp.arange(W * H, dtype=jnp.int32)
    opts = JOptions(spp=REF_SPP)
    with jax_dense_pallas_interpret():
        idx, rgb, _, _ = jax.jit(lambda: JL.trace_sample(
            scene, cam, lane, SAMPLE, REF_SEED, opts))()
        parts = JL.render(scene, cam, JOptions(spp=2), 5, 2,
                          return_parts=True)
        check = JL.raster_check(scene, cam, opts)
        err = jax.jit(JL.raster_roundtrip_error)(scene, cam)
    return dict(scene=flatten(scene), cam=flatten(cam),
                idx=[np.asarray(i) for i in idx],
                rgb=[np.stack([np.asarray(c) for c in v], -1) for v in rgb],
                parts=[np.asarray(a) for a in parts],
                check=np.asarray(check), err=float(err))


@pytest.fixture(scope="module")
def port_box(jax_box):
    return scene_from_numpy(jax_box["scene"], device="cpu"), \
        camera_from_numpy(jax_box["cam"], device="cpu")


def test_trace_sample_per_lane_matches_jax(jax_box, port_box):
    scene, cam = port_box
    lane = torch.arange(W * H, dtype=torch.int32)
    idx, rgb, didx, drgb = PL.trace_sample(scene, cam, lane, SAMPLE,
                                           REF_SEED, RenderOptions())
    assert len(idx) == len(rgb) == 2      # the direct splat + 1 connection
    assert torch.equal(idx[0], didx) and drgb is rgb[0]
    for i, (got_i, got_v, want_i, want_v) in enumerate(
            zip(idx, rgb, jax_box["idx"], jax_box["rgb"])):
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), want_i, err_msg=str(i))
        live = want_i >= 0
        assert live.sum() > 20, (i, live.sum())
        np.testing.assert_allclose(got_v.stack().numpy()[live],
                                   want_v[live], rtol=1e-4, atol=1e-5)


def test_return_parts_and_composition_match_jax(jax_box, port_box):
    """The raw accumulators of a chunk (spp 2 from sample 2): the splat
    sums and the direct pane's max, each as JAX's, the mask exact; and
    composing them gives the render."""
    scene, cam = port_box
    splat, direct, dmask = PL.render(scene, cam, RenderOptions(spp=2), 5, 2,
                                     return_parts=True)
    j_splat, j_direct, j_mask = jax_box["parts"]
    assert dmask.dtype == torch.bool and dmask.shape == (H, W)
    np.testing.assert_array_equal(dmask.numpy(), j_mask)
    assert j_mask.sum() > 5
    _assert_image_close(splat.numpy(), j_splat)
    np.testing.assert_allclose(direct.numpy(), j_direct, rtol=1e-4,
                               atol=1e-5)
    composed = PL.compose_light_film(scene, cam, splat, direct, dmask, 2)
    torch.testing.assert_close(
        composed, PL.render(scene, cam, RenderOptions(spp=2), 5, 2))
    # two chunks combine into the whole render: sums add, maxes max
    first = PL.render(scene, cam, RenderOptions(spp=2), 5, 0,
                      return_parts=True)
    whole = PL.compose_light_film(
        scene, cam, first[0] + splat, torch.maximum(first[1], direct),
        first[2] | dmask, 4)
    torch.testing.assert_close(
        whole, PL.render(scene, cam, RenderOptions(spp=4), 5),
        rtol=1e-5, atol=1e-6)


def test_raster_check_matches_jax(jax_box, port_box):
    scene, cam = port_box
    check = PL.raster_check(scene, cam, RenderOptions())
    np.testing.assert_array_equal(check.numpy(), jax_box["check"])
    err = PL.raster_roundtrip_error(scene, cam)
    assert err.dtype == torch.float32 and err.ndim == 0
    assert float(err) == pytest.approx(jax_box["err"], abs=1e-7)
    assert float(err) < 0.25


# -------------------------------------------------- the camera's raster chain

def _points(cam, n=400, seed=8):
    """World points: in front of the camera across and beyond the frame,
    behind it, and on the camera's plane (w = 0)."""
    r = np.random.RandomState(seed)
    pts = np.concatenate([
        r.randn(n, 3) * np.array([1.5, 1.5, 1.0]) + np.array([0, 0, 0]),
        r.randn(n // 4, 3) * 4.0 - np.array([0, 0, 8.0]),
        np.array([[0.0, 0.0, -3.2], [0.3, 0.2, -3.2]])], 0)
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def jax_grad_camera():
    cam = JC.make_camera(W, H, 60, eye=(0, 0, -3.2), viewdir=(0, 0, 1),
                         updir=(0, 1, 0))
    return cam, camera_from_numpy(flatten(cam), device="cpu")


def test_raster_functions_match_jax(jax_grad_camera):
    jcam, cam = jax_grad_camera
    pts = _points(jcam)
    jp = JVec3(*(jnp.asarray(pts[:, i]) for i in range(3)))
    pp = Vec3(*(torch.from_numpy(pts[:, i].copy()) for i in range(3)))
    jrx, jry = JC.world_to_raster(jcam, jp)
    rx, ry = PC.world_to_raster(cam, pp)
    np.testing.assert_allclose(rx.numpy(), np.asarray(jrx), rtol=1e-6)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), rtol=1e-6)
    j_we, j_idx = JC.importance_we(jcam, jp)
    we, idx = PC.importance_we(cam, pp)
    assert idx.dtype == torch.int32
    finite = np.isfinite(np.asarray(jrx)) & np.isfinite(np.asarray(jry))
    np.testing.assert_array_equal(idx.numpy()[finite],
                                  np.asarray(j_idx)[finite])
    np.testing.assert_allclose(we.numpy()[finite], np.asarray(j_we)[finite],
                               rtol=1e-5)
    np.testing.assert_array_equal(
        PC.world_to_pixel_index(cam, pp).numpy(), idx.numpy())
    inside = idx.numpy() >= 0
    assert inside.sum() > 50 and (~inside).sum() > 50


def test_non_finite_raster_is_outside():
    """A point on the camera's plane projects to a non-finite raster
    coordinate (w = 0). The port gives index -1 and We 0 there, whatever
    the device's float-to-int cast does; XLA on the CPU casts NaN to 0, so
    the JAX package can accept such a point as column or row 0."""
    jcam = JC.make_camera(W, H, 60, eye=(0, 0, -3.2), viewdir=(0, 0, 1),
                          updir=(0, 1, 0))
    cam = camera_from_numpy(flatten(jcam), device="cpu")
    pts = np.array([[0.0, 0.0, -3.2], [0.5, 0.1, -3.2]], np.float32)
    jp = JVec3(*(jnp.asarray(pts[:, i]) for i in range(3)))
    pp = Vec3(*(torch.from_numpy(pts[:, i].copy()) for i in range(3)))
    rx, ry = PC.world_to_raster(cam, pp)
    assert not bool((torch.isfinite(rx) & torch.isfinite(ry)).any())
    j_rx, _ = JC.world_to_raster(jcam, jp)
    assert not np.isfinite(np.asarray(j_rx)).any()
    we, idx = PC.importance_we(cam, pp)
    assert idx.tolist() == [-1, -1] and we.tolist() == [0.0, 0.0]
    # NaN raster (0/0 at the eye) -> column 0 in XLA's cast
    assert int(JC.world_to_pixel_index(jcam, jp)[0]) >= 0


def test_world_to_pixel_index_truncation_band():
    """The port form of test_quirks.py's case: the reference bounds-checks
    the TRUNCATED ints (Camera.hpp:52-55), so raster values in (-1, 0) fold
    onto row/column 0 and are accepted."""
    cam = PC.make_camera(64, 64, 55, eye=(0, 0.35, 2.6),
                         viewdir=(0, -0.12, -1), updir=(0, 1, 0),
                         device="cpu")
    p0 = PC.pixel_position(cam, torch.tensor([32]), torch.tensor([0]))
    assert int(PC.world_to_pixel_index(cam, p0)[0]) == 32
    half = cam.delta_v * -0.5
    assert int(PC.world_to_pixel_index(cam, p0 + half)[0]) == 32
    assert int(PC.world_to_pixel_index(cam, p0 + half * 4.0)[0]) == -1
