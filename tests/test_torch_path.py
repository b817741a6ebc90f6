"""The path tracer end to end: the PyTorch port against the JAX package.

- the dense slice on simple_box, both fed the same scene tables built once
  in JAX, the JAX side taking its dense Pallas Woop kernels in interpret
  mode (the kernels the port's CUDA kernels replace);
- the mesh-scale slice (``MESH_CASES`` of ``torch_port_util``):
  sphere_showcase(24, 20, nu=46, nv=46), 4,236 triangles with cluster
  tables, under the MIS and the NEE-only estimator, and its translucent
  variant (the sphere at alpha 0.5) under ``alpha_shadows``, each built by
  the port's own builder and held against the JAX package's own CPU route
  for that scene (its XLA BVH and dense transmittance); and simple_box
  under ``mis=False`` and ``alpha_shadows``, the JAX side's K1/K2 in
  interpret mode. On the CPU the port's cluster wrappers run their plain
  versions, which the CUDA kernels match on the card (chip_smoke.py).

Tolerances, the same for every case:

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

from torch_port_util import (MESH_CASES, MESH_REFS, REF_PATH, REF_SEED,
                             REF_SIZE, REF_SPP, SHOWCASE_NU, SHOWCASE_NV,
                             check_stored, flatten,
                             jax_dense_pallas_interpret,
                             jax_mesh_render, jax_mesh_scene,
                             jax_reference_render, jax_route,
                             translucent_showcase)
from torch_port_util import mesh_case as mesh_case_json
from tuturenderer_tpu.camera import primary_ray as j_primary_ray
from tuturenderer_tpu.integrators.path import trace_rays as j_trace_rays
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu_torch.camera import camera_from_numpy, primary_ray
from tuturenderer_tpu_torch.integrators.path import render, trace_rays
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_image
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.scene.presets import simple_box

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
    return scene_from_numpy(scene_arrays, device="cpu"), \
        camera_from_numpy(cam_arrays, device="cpu")


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


@pytest.mark.parametrize("kwargs", [dict(integrator="bdpt"),
                                    dict(postprocess=True)],
                         ids=["bdpt", "postprocess"])
def test_unported_options_raise(port_box, kwargs):
    """The options that raised, naming their ROADMAP item, until the
    port served them, now render: the bdpt integrator (item 12b,
    tests/test_torch_bdpt*.py) and ``postprocess`` (13b: bloom and tone
    mapping of the linear render, tests/test_torch_post.py); so does
    compaction (tests/test_torch_compaction*.py)."""
    from tuturenderer_tpu_torch.post import bloom_and_tonemap
    scene, cam = port_box
    opts = RenderOptions(spp=1, bdpt_max_path_length=2)
    img = render_image(scene, cam, opts, **kwargs)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    if kwargs.get("postprocess"):
        np.testing.assert_array_equal(
            img, bloom_and_tonemap(render_image(scene, cam, opts)).numpy())


# ------------------------------------------------ the mesh-scale slice

def _port_mesh_scene(name):
    kind = MESH_CASES[name][0]
    if kind == "showcase":
        return sphere_showcase(W, H, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                               device="cpu")
    if kind == "translucent":
        return translucent_showcase("tuturenderer_tpu_torch", W, H,
                                    device="cpu")
    return simple_box(W, H, device="cpu")


@pytest.fixture(scope="module", params=sorted(MESH_CASES))
def mesh_case(request):
    """(name, JAX image, JAX per-lane radiance, JAX live counts)."""
    name = request.param
    scene, cam = jax_mesh_scene(name)
    opts = JOptions(spp=REF_SPP, **MESH_CASES[name][1])
    img = jax_mesh_render(name, scene, cam)
    lane = jnp.arange(W * H, dtype=jnp.int32)
    o, d, _ = j_primary_ray(cam, lane % W, lane // W)

    @jax.jit
    def trace(o, d):
        return j_trace_rays(scene, cam, o, d, lane, SAMPLE, REF_SEED, opts,
                            collect_alive=True)

    with jax_route(name):
        L, counts = trace(o, d)
        L = np.stack([np.asarray(c) for c in L], axis=-1)
    return name, img, L, np.asarray(counts)


def test_mesh_scenes_carry_cluster_tables():
    for name in MESH_CASES:
        scene, _ = _port_mesh_scene(name)
        assert (scene.clusters is not None) == \
            (MESH_CASES[name][0] != "box"), name


def test_mesh_render_matches_jax(mesh_case):
    name, want = mesh_case[:2]
    scene, cam = _port_mesh_scene(name)
    opts = RenderOptions(spp=REF_SPP, **MESH_CASES[name][1])
    img = render(scene, cam, opts, seed=REF_SEED)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    _assert_lanes_close(img.numpy(), want)


def test_mesh_trace_rays_per_lane_matches_jax(mesh_case):
    name, _, want, want_counts = mesh_case
    scene, cam = _port_mesh_scene(name)
    lane = torch.arange(W * H, dtype=torch.int32)
    o, d, _ = primary_ray(cam, lane % W, lane // W)
    opts = RenderOptions(spp=REF_SPP, **MESH_CASES[name][1])
    L, counts = trace_rays(scene, cam, o, d, lane, SAMPLE, REF_SEED, opts,
                           collect_alive=True)
    _assert_lanes_close(L.stack().numpy(), want)
    assert counts.shape == want_counts.shape
    assert np.abs(counts.numpy() - want_counts).max() <= 0.01 * W * H


def test_stored_mesh_reference_is_the_jax_render(mesh_case):
    """chip_smoke.py renders each stored case as its file says and holds
    the card's render against the image."""
    name, img = mesh_case[:2]
    check_stored(MESH_REFS[name], {"image": img}, mesh_case_json(name))


def test_translucent_shadows_are_lighter():
    """alpha 0.5 lets light through the sphere's shadow: the translucent
    scene under alpha_shadows is brighter than the opaque one, and equal
    to it without alpha_shadows (alpha changes nothing else)."""
    opaque, cam = _port_mesh_scene("showcase-mis")
    clear, _ = _port_mesh_scene("translucent-alpha")
    opts = RenderOptions(spp=2, alpha_shadows=True)
    a = render(opaque, cam, opts, seed=1)
    b = render(clear, cam, opts, seed=1)
    assert b.mean() > a.mean() * 1.05
    torch.testing.assert_close(render(clear, cam, RenderOptions(spp=2), 1),
                               render(opaque, cam, RenderOptions(spp=2), 1))
