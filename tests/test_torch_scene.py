"""Scene tables, camera and primary rays of the PyTorch port against the JAX
package, and the port's independence from JAX.

Tolerances: every SceneData array exactly equal (dtype included; the Woop
rows are factorised by the same float64 numpy calls, so they are
bit-equal); primary rays within rtol 1e-6 (float32 rounding of the same
expression)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import flatten
from tuturenderer_tpu.camera import primary_ray as j_primary_ray
from tuturenderer_tpu.scene import data as jdata
from tuturenderer_tpu.scene.presets import simple_box as j_simple_box
from tuturenderer_tpu_torch.camera import camera_from_numpy, primary_ray
from tuturenderer_tpu_torch.scene import data as tdata
from tuturenderer_tpu_torch.scene.presets import simple_box

W, H = 24, 20


def _textured(mod):
    """A small builder scene with every texture category, uvs and spheres."""
    r = np.random.RandomState(4)
    b = mod.SceneBuilder(bkgcolor=(0.1, 0.2, 0.3), eta=1.2)
    dm = b.add_texture("diffuse", "d", r.rand(5, 7, 3))
    nm = b.add_texture("normal", "n", r.rand(4, 4, 3) * 2 - 1)
    rm = b.add_texture("roughness", "r", r.rand(3, 6, 3))
    mm = b.add_texture("metallic", "m", r.rand(6, 3, 3))
    tex = b.add_material(mod.MICROFACET_R, diffuse=(0.5, 0.4, 0.3),
                         roughness=0.3, metallic=0.2, diffuse_map=dm,
                         normal_map=nm, roughness_map=rm, metallic_map=mm)
    lam = b.add_material(mod.LAMBERTIAN, diffuse=(0.7, 0.7, 0.7))
    light = b.add_material(mod.LAMBERTIAN, emission=(5.0, 4.0, 3.0))
    verts = r.randn(10, 3, 3).astype(np.float32)
    uvs = r.rand(10, 3, 2).astype(np.float32) * 3 - 1
    b.add_triangles(verts[:6], None, uvs[:6], tex)
    b.add_triangles(verts[6:8], verts[6:8] * 0 + [0, 0, 1], None, lam)
    b.add_triangles(verts[8:], None, None, light)
    b.add_sphere((0.0, 0.5, 2.0), 0.5, tex)
    b.add_sphere((1.0, -0.5, 2.0), 0.3, light)
    return b.build()


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_box():
    scene, cam = j_simple_box(W, H)
    return flatten(scene), flatten(cam), cam


def test_scene_from_numpy_round_trips_simple_box(jax_box):
    arrays, _, _ = jax_box
    scene = tdata.scene_from_numpy(arrays)
    _assert_same_arrays(flatten(scene), arrays)
    assert scene.mtype_set == (0, 1, 2) and not scene.has_textures


def test_builder_matches_jax_simple_box(jax_box):
    arrays, _, _ = jax_box
    scene, _ = simple_box(W, H)
    _assert_same_arrays(flatten(scene), arrays)


def test_builder_matches_jax_textured_scene():
    want = flatten(_textured(jdata))
    got = flatten(_textured(tdata))
    _assert_same_arrays(got, want)
    assert bool(got["has_textures"])


def test_cluster_scenes_raise():
    b = tdata.SceneBuilder()
    m = b.add_material()
    b.add_triangles(np.zeros((2, 3, 3), np.float32), None, None, m)
    with pytest.raises(NotImplementedError, match="item 10"):
        b.build(use_bvh=True)
    b.add_triangles(np.random.RandomState(0).randn(4094, 3, 3), None, None, m)
    with pytest.raises(NotImplementedError, match="4096 triangles"):
        b.build()


def test_camera_from_numpy_matches_make_camera(jax_box):
    _, cam_arrays, _ = jax_box
    _, cam = simple_box(W, H)
    _assert_same_arrays(flatten(camera_from_numpy(cam_arrays)), cam_arrays)
    _assert_same_arrays(flatten(cam), cam_arrays)


def test_primary_rays_match_jax(jax_box):
    _, cam_arrays, jcam = jax_box
    pix = np.arange(W * H, dtype=np.int32)
    jo, jd, jp = j_primary_ray(jcam, jnp.asarray(pix % W),
                               jnp.asarray(pix // W))
    cam = camera_from_numpy(cam_arrays)
    t = torch.from_numpy(pix)
    o, d, p = primary_ray(cam, t % W, t // W)
    for got, want in ((o, jo), (d, jd), (p, jp)):
        for c in range(3):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                       rtol=1e-6, atol=1e-7)


def test_port_imports_and_renders_without_jax():
    code = (
        "import sys\n"
        "from tuturenderer_tpu_torch.integrators.path import render\n"
        "from tuturenderer_tpu_torch.options import RenderOptions\n"
        "from tuturenderer_tpu_torch.scene.presets import simple_box\n"
        "s, c = simple_box(8, 8)\n"
        "img = render(s, c, RenderOptions(spp=1))\n"
        "assert img.shape == (8, 8, 3) and bool(img.isfinite().all())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('tuturenderer_tpu.') or m == 'tuturenderer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
