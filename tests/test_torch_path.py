"""The slice end to end: the PyTorch port's path tracer against the JAX
package on simple_box, both fed the same scene tables built once in JAX.

The JAX side takes its dense Pallas Woop kernels in interpret mode, the
kernels the port's CUDA kernels replace. Tolerances:

- >= 99 % of pixels (lanes) within rtol 1e-4 / atol 1e-5 on all three
  channels: both packages draw the same random numbers, so most lanes
  follow the same path; a Russian-roulette or lottery draw compared
  against a threshold can flip on a 1-ulp difference (XLA's rsqrt, sin and
  cos are not PyTorch's) and send a lane elsewhere;
- image mean within 0.5 %, for the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (REF_PATH, REF_SEED, REF_SIZE, REF_SPP, flatten,
                             jax_dense_pallas_interpret, jax_reference_render)
from tuturenderer_tpu.camera import primary_ray as j_primary_ray
from tuturenderer_tpu.integrators.path import trace_rays as j_trace_rays
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu_torch.camera import camera_from_numpy, primary_ray
from tuturenderer_tpu_torch.integrators.path import render, trace_rays
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import scene_from_numpy

W, H = REF_SIZE
SAMPLE = 1


def _assert_lanes_close(got, want):
    """got/want [..., 3]: the per-lane and image-mean criteria above."""
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


@pytest.fixture(scope="module")
def jax_side():
    scene, cam = j_simple_box(W, H)
    img = jax_reference_render()
    lane = jnp.arange(W * H, dtype=jnp.int32)
    o, d, _ = j_primary_ray(cam, lane % W, lane // W)

    @jax.jit
    def trace(o, d):
        return j_trace_rays(scene, cam, o, d, lane, SAMPLE, REF_SEED,
                            JOptions(spp=REF_SPP), collect_alive=True)

    with jax_dense_pallas_interpret():
        L, counts = trace(o, d)
        L = np.stack([np.asarray(c) for c in L], axis=-1)
    return flatten(scene), flatten(cam), img, L, np.asarray(counts)


@pytest.fixture(scope="module")
def port_box(jax_side):
    scene_arrays, cam_arrays = jax_side[:2]
    return scene_from_numpy(scene_arrays), camera_from_numpy(cam_arrays)


def test_stored_reference_is_the_jax_render(jax_side):
    """chip_smoke.py holds the GPU render against the stored image; it must
    be what the JAX package renders now."""
    np.testing.assert_array_equal(np.load(REF_PATH), jax_side[2])


def test_render_matches_jax(jax_side, port_box):
    scene, cam = port_box
    img = render(scene, cam, RenderOptions(spp=REF_SPP), seed=REF_SEED)
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    _assert_lanes_close(img.numpy(), jax_side[2])


def test_trace_rays_per_lane_matches_jax(jax_side, port_box):
    """One MIS wavefront, per lane, with the live-lane counts per bounce."""
    scene, cam = port_box
    lane = torch.arange(W * H, dtype=torch.int32)
    o, d, _ = primary_ray(cam, lane % W, lane // W)
    L, counts = trace_rays(scene, cam, o, d, lane, SAMPLE, REF_SEED,
                           RenderOptions(spp=REF_SPP), collect_alive=True)
    _assert_lanes_close(L.stack().numpy(), jax_side[3])
    want = jax_side[4]
    assert counts.shape == want.shape
    assert np.abs(counts.numpy() - want).max() <= 0.01 * W * H


def test_samples_per_launch_and_sample_base_keep_the_stream(port_box):
    """Batching spp into one wavefront, or continuing a render from
    sample_base, draws the same samples as one render."""
    scene, cam = port_box
    one = render(scene, cam, RenderOptions(spp=4), seed=5)
    batched = render(scene, cam, RenderOptions(spp=4, samples_per_launch=2),
                     seed=5)
    torch.testing.assert_close(batched, one, rtol=1e-5, atol=1e-6)
    halves = [render(scene, cam, RenderOptions(spp=2), seed=5, sample_base=b)
              for b in (0, 2)]
    torch.testing.assert_close((halves[0] + halves[1]) * 0.5, one,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opts", [
    RenderOptions(spp=1, mis=False),
    RenderOptions(spp=1, compaction=(1.0, 0.5)),
    RenderOptions(spp=1, alpha_shadows=True),
    RenderOptions(spp=1, differentiable=True)],
    ids=["nee-only", "compaction", "alpha-shadows", "differentiable"])
def test_unported_options_raise(port_box, opts):
    scene, cam = port_box
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        render(scene, cam, opts)
