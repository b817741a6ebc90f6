"""The differentiable path tracer of the PyTorch port (``grad.py``, the
detached-sampling branch of ``integrators/path.py``).

- against the JAX package: the ``render_diff`` image and the gradient of
  its mean for every MaterialParams leaf, on tests/test_grad.py's
  diffuse_box (MIS) and ggx_box (NEE-only, a GGX sphere), both fed the
  same scene tables; the port takes its Moller-Trumbore dense route
  (K3/K4's plain versions), the arithmetic of the JAX package's CPU route.
  The JAX side is one traced graph per scene, computed once per module;
  the stored references of ``tests/data/make_torch_grad_refs.py`` (which
  chip_smoke.py holds the card to) must equal it;
- on the port itself: tests/test_grad.py's finite-difference checks,
  ``get_params`` / ``put_params``, the forward value of ``render_diff``,
  and the ``--invert`` loop of tests/test_cli.py on its scene.

Tolerances against the JAX package: >= 99 % of pixels within rtol 1e-4 /
atol 1e-5 and the image mean within 0.5 % (as for every render of the
port), and each gradient leaf within 1e-3 of its largest magnitude. Both
packages draw the same random numbers and, at 24x20, follow the same paths
on every lane; what differs is the rounding of rsqrt, sqrt and pow in XLA
and PyTorch (measured: 1e-7 relative on diffuse_box, 6e-5 on ggx_box's
roughness). The finite-difference tolerances are tests/test_grad.py's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import (GRAD_CASES, GRAD_LEAVES, GRAD_REFS, GRAD_SEED,
                             check_stored, flatten, grad_case, jax_grad_case,
                             jax_grad_scene)
from tuturenderer_tpu.grad import get_params as j_get_params
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.camera import camera_from_numpy, make_camera
from tuturenderer_tpu_torch.integrators.path import render
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import cluster as C
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import (LAMBERTIAN, SceneBuilder,
                                               scene_from_numpy)
from tuturenderer_tpu_torch.tools import proto_visit as P


@pytest.fixture(autouse=True)
def port_mt(monkeypatch):
    """The port's dense route in its MT form, as the JAX package's CPU
    route computes."""
    monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")


def _port(arrays: dict, prefix: str):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _port_case(name: str):
    """The port's (scene, camera) of a GRAD_CASES entry, from the JAX
    tables."""
    scene, cam = jax_grad_scene(name)
    return (scene_from_numpy(flatten(scene), device="cpu"),
            camera_from_numpy(flatten(cam), device="cpu"))


def _opts(name: str, **kw) -> RenderOptions:
    return RenderOptions(**{**GRAD_CASES[name][1], **kw})


def _grads(scene, cam, opts, seed, params=None):
    """(image, [8 leaf gradients of the image mean]) from the port."""
    params = G.get_params(scene) if params is None else params
    leaves = [a.detach().clone().requires_grad_(True)
              for a in params.leaves()]
    img = G.render_diff(G.MaterialParams.from_leaves(leaves), scene, cam,
                        opts, seed)
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    return img.detach(), [torch.zeros_like(a) if g is None else g
                          for a, g in zip(leaves, grads)]


def _loss(params, scene, cam, opts, seed) -> float:
    with torch.no_grad():
        return float(G.render_diff(params, scene, cam, opts, seed).mean())


def _fd(scene, cam, opts, seed, leaf, idx, eps):
    flat = G.get_params(scene).leaves()

    def perturb(sign):
        fl = [a.clone() for a in flat]
        fl[leaf][idx] += sign * eps
        return G.MaterialParams.from_leaves(fl)

    return (_loss(perturb(+1.0), scene, cam, opts, seed) -
            _loss(perturb(-1.0), scene, cam, opts, seed)) / (2 * eps)


# ------------------------------------------------ against the JAX package

@pytest.fixture(scope="module", params=sorted(
    n for n, case in GRAD_CASES.items() if case[2] == "render_diff"))
def jax_case(request):
    return request.param, jax_grad_case(request.param)


def test_image_and_gradients_match_jax(jax_case):
    name, want = jax_case
    scene = scene_from_numpy(_port(want, "scene."), device="cpu")
    cam = camera_from_numpy(_port(want, "camera."), device="cpu")
    img, grads = _grads(scene, cam, _opts(name), GRAD_SEED)
    got, ref = img.numpy(), want["image"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.005 * abs(ref.mean())
    nonzero = 0
    for key, g in zip(GRAD_LEAVES, grads):
        w = want[f"grad.{key}"]
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale,
                                   err_msg=key)
        nonzero += int((w != 0).sum())
    assert nonzero >= 6


def test_stored_gradient_reference_is_the_jax_computation(jax_case):
    """chip_smoke.py holds the card's gradients to these files, computed as
    each file's ``case`` says; they must be what the JAX package computes
    now."""
    name, want = jax_case
    check_stored(GRAD_REFS[name], want, grad_case(name), rtol=1e-6)


def test_params_from_numpy_takes_jax_params():
    jscene, _ = jax_grad_scene("ggx-nee")
    jp = j_get_params(jscene)
    arrays = {f"{f}.{c}": np.asarray(getattr(getattr(jp, f), c))
              for f in ("diffuse", "emission") for c in "xyz"}
    arrays.update(roughness=np.asarray(jp.roughness),
                  metallic=np.asarray(jp.metallic))
    p = G.params_from_numpy(arrays, device="cpu")
    want = G.get_params(_port_case("ggx-nee")[0])
    for a, b in zip(p.leaves(), want.leaves()):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------ the port on its own

def test_render_diff_forward_is_render():
    """The forward value of render_diff is the render of the same seed:
    bit-equal one sample per batch; to rounding with two (the per-batch
    sums add in another order)."""
    scene, cam = _port_case("diffuse-mis")
    for opts in (_opts("diffuse-mis"), _opts("ggx-nee")):
        torch.testing.assert_close(
            G.render_diff(G.get_params(scene), scene, cam, opts, 3),
            render(scene, cam, opts, seed=3), rtol=0, atol=0)
    opts = _opts("diffuse-mis", spp=4, samples_per_launch=2)
    torch.testing.assert_close(
        G.render_diff(G.get_params(scene), scene, cam, opts, 3),
        render(scene, cam, opts, seed=3), rtol=1e-5, atol=1e-6)


def test_put_params_refreshes_light_emission():
    """put_params carries emission edits into the per-light emission table,
    so NEE sees them: a doubled emission exactly doubles the render."""
    scene, cam = _port_case("diffuse-mis")
    params = G.get_params(scene)
    bumped = params._replace(emission=params.emission * 2.0)
    s2 = G.put_params(scene, bumped)
    torch.testing.assert_close(s2.light_emission.x,
                               2.0 * scene.light_emission.x)
    torch.testing.assert_close(s2.materials.emission.y,
                               2.0 * scene.materials.emission.y)
    opts = RenderOptions(spp=2, max_depth=2)
    base = G.render_diff(params, scene, cam, opts, seed=3)
    bright = G.render_diff(bumped, scene, cam, opts, seed=3)
    torch.testing.assert_close(bright, 2.0 * base, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def diffuse_setup():
    scene, cam = _port_case("diffuse-mis")
    return scene, cam, _grads(scene, cam, _opts("diffuse-mis"), 7)[1]


def test_albedo_gradient_matches_fd(diffuse_setup):
    scene, cam, grads = diffuse_setup
    g = float(grads[0][0])              # diffuse.x of the white walls
    fd = _fd(scene, cam, _opts("diffuse-mis"), 7, 0, 0, 1e-2)
    assert g != 0.0
    np.testing.assert_allclose(g, fd, rtol=5e-2)


def test_emission_gradient_matches_fd(diffuse_setup):
    scene, cam, grads = diffuse_setup
    g = float(grads[3][2])              # emission.x of the light
    fd = _fd(scene, cam, _opts("diffuse-mis"), 7, 3, 2, 1e-1)
    assert g != 0.0
    np.testing.assert_allclose(g, fd, rtol=1e-2)


def test_red_wall_gradient_localized(diffuse_setup):
    _, _, grads = diffuse_setup
    for g in grads:
        assert bool(torch.isfinite(g).all())
    assert float(grads[0][1]) != 0.0    # the red material's diffuse.x


@pytest.mark.parametrize("seed", [7, 11])
def test_roughness_and_metallic_gradients_match_fd_nee(seed):
    """NEE-only at depth 0 the sampler never reads roughness or metallic,
    so the detached gradient is exact (tests/test_grad.py's eps and
    tolerances)."""
    scene, cam = _port_case("ggx-nee")
    opts = _opts("ggx-nee")
    _, grads = _grads(scene, cam, opts, seed)
    ad_r, ad_m = float(grads[6][1]), float(grads[7][1])
    assert ad_r != 0.0 and ad_m != 0.0
    np.testing.assert_allclose(ad_r, _fd(scene, cam, opts, seed, 6, 1, 2e-3),
                               rtol=2e-2)
    np.testing.assert_allclose(ad_m, _fd(scene, cam, opts, seed, 7, 1, 1e-2),
                               rtol=1e-2)


def test_metallic_gradient_matches_fd_full_mis():
    """Full MIS: the GGX sampler reads roughness but not metallic, so the
    metallic gradient stays exact up to RR flips; seed-averaged."""
    scene, cam = _port_case("ggx-nee")
    opts = RenderOptions(spp=8, max_depth=3, samples_per_launch=8)
    seeds = (7, 11)
    ad = np.mean([float(_grads(scene, cam, opts, s)[1][7][1])
                  for s in seeds])
    fd = np.mean([_fd(scene, cam, opts, s, 7, 1, 1e-2) for s in seeds])
    assert ad != 0.0
    np.testing.assert_allclose(ad, fd, rtol=5e-2)


# the scene of tests/test_cli.py INVERT_CONFIG: a wall facing the camera
# under a downward-facing triangle light, 16x16
def _invert_scene(diffuse):
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    wall = b.add_material(LAMBERTIAN, diffuse=diffuse)
    b.add_triangles(np.asarray([[[-2, -2, -1], [2, -2, -1], [0, 2, -1]]],
                               np.float32), None, None, wall)
    light = b.add_material(LAMBERTIAN, diffuse=diffuse,
                           emission=(8.0, 8.0, 8.0))
    b.add_triangles(np.asarray([[[-0.5, 0.9, 0.5], [0, 0.9, -0.5],
                                 [0.5, 0.9, 0.5]]], np.float32), None, None,
                    light)
    cam = make_camera(16, 16, 60, eye=(0, 0, 3), viewdir=(0, 0, -1),
                      updir=(0, 1, 0), device="cpu")
    return b.build(device="cpu"), cam


def test_inverse_rendering_recovers_albedo():
    """tests/test_cli.py's --invert run: the target is the render with the
    true albedo (0.8, 0.2, 0.2) as the CLI reads it back from an image
    file, clipped to [0, 1] (the light's radiance 8 reads as 1); gradient
    descent starts from the wrong (0.2, 0.6, 0.7) at lr 10 for 40 steps.
    The L2 loss must collapse >= 20x (test_cli.py's bar), and a render
    with the recovered materials must be nearer the target than one with
    the wrong materials, in the clipped image."""
    # the four samples share one wavefront: the same estimate, fewer ops
    opts = RenderOptions(spp=4, max_depth=2, samples_per_launch=4)
    true_scene, cam = _invert_scene((0.8, 0.2, 0.2))
    target = torch.clamp(render(true_scene, cam, opts, seed=0), 0.0, 1.0)
    scene, _ = _invert_scene((0.2, 0.6, 0.7))
    params, losses = G.invert_materials(G.get_params(scene), target, scene,
                                        cam, opts, steps=40, lr=10.0)
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert losses[-1] < 0.05 * losses[0], losses

    def dist(s):
        img = torch.clamp(render(s, cam, opts, seed=0), 0.0, 1.0)
        return float((img - target).abs().mean())

    assert dist(G.put_params(scene, params)) < 0.8 * dist(scene)


def test_image_loss_and_grad_is_the_loss_gradient():
    scene, cam = _port_case("diffuse-mis")
    opts = RenderOptions(spp=2, max_depth=2)
    target = torch.full((cam.height, cam.width, 3), 0.3)
    params = G.get_params(scene)
    loss, g = G.image_loss_and_grad(params, target, scene, cam, opts, 5)
    img = G.render_diff(params, scene, cam, opts, 5)
    torch.testing.assert_close(loss, torch.mean((img - target) ** 2))
    assert not any(a.requires_grad for a in params.leaves())
    eps = 1e-2

    def at(sign):
        fl = [a.clone() for a in params.leaves()]
        fl[1][0] += sign * eps           # diffuse.y of the white walls
        p = G.MaterialParams.from_leaves(fl)
        with torch.no_grad():
            im = G.render_diff(p, scene, cam, opts, 5)
        return float(torch.mean((im - target) ** 2))

    np.testing.assert_allclose(float(g.diffuse.y[0]),
                               (at(1.0) - at(-1.0)) / (2 * eps), rtol=5e-2)


def test_unported_differentiable_integrators_raise():
    """The light tracer's and BDPT's differentiable renderers (ROADMAP item
    12b) are served now: each gives a finite image and a gradient
    (against the JAX package: tests/test_torch_bdpt_grad*.py)."""
    scene, cam = _port_case("diffuse-mis")
    for fn, opts in ((G.render_light_diff, RenderOptions(spp=1)),
                     (G.render_bdpt_diff,
                      RenderOptions(spp=1, bdpt_max_path_length=2))):
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in G.get_params(scene).leaves()]
        img = fn(G.MaterialParams.from_leaves(leaves), scene, cam, opts, 1)
        g, = torch.autograd.grad(img.mean(), leaves[3])
        assert bool(torch.isfinite(img).all())
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """A gradient must never be dropped at a kernel's raw pointer: every
    wrapper raises on a ray column that requires grad (the path tracer
    detaches the rays where they enter a kernel)."""
    rays = [torch.zeros(8) for _ in range(6)]
    rays[4] = torch.ones(8, requires_grad=True)
    dist = torch.ones(8)
    for fn, table in ((K.tri_intersect, torch.zeros(13)),
                      (K.tri_intersect_mt, torch.zeros(12))):
        with pytest.raises(ValueError, match="requires grad"):
            fn(table, *rays)
    for fn, table in ((K.tri_occluded, torch.zeros(13)),
                      (K.tri_occluded_mt, torch.zeros(12))):
        with pytest.raises(ValueError, match="requires grad"):
            fn(table, *[r.detach() for r in rays],
               torch.ones(8, requires_grad=True))
    scene, _ = sphere_showcase(8, 8, nu=46, nv=46, device="cpu")
    for fn, extra in ((C.cluster_intersect, ()),
                      (C.cluster_occluded, (dist,)),
                      (C.cluster_transmittance, (dist,))):
        with pytest.raises(ValueError, match="requires grad"):
            fn(scene.clusters, *rays, *extra)
    args = P.tensors(P.scenario("early", 8, 1), "cpu")
    args[2].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        P.run(*args, nc=8)


def test_gradients_flow_past_detached_kernel_inputs():
    """The rays of a differentiable render carry no gradient into the
    kernels, and the material gradients still arrive (the wrappers would
    raise otherwise)."""
    scene, cam = _port_case("ggx-nee")
    img, grads = _grads(scene, cam, RenderOptions(spp=1, max_depth=2), 1)
    assert bool(torch.isfinite(img).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().sum()) > 0.0



def test_gradient_slice_imports_without_jax():
    """grad.py and the visit-walk probe import neither jax, the JAX package
    nor the repository's tools/, and a gradient runs without them."""
    code = (
        "import sys\n"
        "import torch\n"
        "from tuturenderer_tpu_torch import grad as G\n"
        "from tuturenderer_tpu_torch.options import RenderOptions\n"
        "from tuturenderer_tpu_torch.scene.presets import simple_box\n"
        "import tuturenderer_tpu_torch.tools.proto_visit\n"
        "s, c = simple_box(8, 8, device='cpu')\n"
        "loss, g = G.image_loss_and_grad(G.get_params(s), torch.zeros(8, 8, 3),"
        " s, c, RenderOptions(spp=1, max_depth=1))\n"
        "assert bool(torch.isfinite(g.diffuse.x).all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tuturenderer_tpu', 'tools')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
