"""BDPT in the PyTorch port (``integrators/bdpt.py``): the port forms of
tests/test_bdpt_mis.py and of tests/test_debug_harness.py's two BDPT tests,
the entry points that serve it, and its import without JAX.

- the MIS partition of unity: for one fixed 2-segment path (camera ->
  floor -> light) the power-heuristic weights of the three strategies that
  can make it, (s=0, t=3), (s=1, t=2) and (s=2, t=1), each from its own
  vertices, sum to 1 within rtol 1e-5 with the MIN_DIVISOR kill off
  (``MIN_DIVISOR`` patched to 0 in the port's module, as the JAX test
  patches the JAX one);
- samples_per_launch changes the schedule only: equal within rtol 1e-5;
- the s-filtered images sum to the full render within rtol 1e-5 / atol
  1e-6, and dropping the MIS weights only adds energy;
- tests/test_grad.py's finite-difference check of ``render_bdpt_diff`` at
  its tolerances (emission rtol 2e-2, diffuse rtol 5e-2);
- the port's render at the default bdpt_max_path_length 7 against the
  stored JAX render ``bdpt-showcase-7`` (test_torch_bdpt_showcase7.py
  holds that file to a fresh JAX render): the (s=1, t=6) connections, the
  t=1 splats of 5- and 6-vertex light paths and the longest MIS chains,
  which the shorter stored cases lack.

The scenes are tests/test_grad.py's diffuse_box, built by the JAX package
and handed to the port as tables (``scene_from_numpy``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import (INTEGRATOR_CASES, INTEGRATOR_REFS, REF_SEED,
                             assert_at_bar, flatten, integrator_fields,
                             port_scene)
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.integrators import bdpt as B
from tuturenderer_tpu_torch.materials import bxdf_pdf, gather_material
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_image
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.scene.presets import simple_box
from tuturenderer_tpu_torch.utils.vec import Vec3


def _diffuse_box(n: int):
    from test_grad import diffuse_box
    scene, cam = diffuse_box(n)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


def v3(x, y, z):
    return Vec3(*(torch.tensor([c], dtype=torch.float32) for c in (x, y, z)))


def test_mis_weights_partition_unity(monkeypatch):
    monkeypatch.setattr(B, "MIN_DIVISOR", 0.0)
    scene, cam = _diffuse_box(8)
    eta = scene.eta
    geo = B.geo
    cpos, cfwd = v3(0, 0, -3.2), v3(0, 0, 1)
    vpos, vng = v3(0.2, -1.0, 0.0), v3(0, 1, 0)
    lpos, lng = v3(0.1, 1.0 - 1e-3, 0.1), v3(0, -1, 0)
    mat_v = gather_material(scene, torch.tensor([0]))
    area0 = float(scene.light_area[0])
    pick_pdf = torch.tensor([1.0 / (scene.n_lights * area0)],
                            dtype=torch.float32)

    unit = lambda a, b: (b - a).normalized(1e-20)
    d_cv = unit(cpos, vpos)
    d_vl = unit(vpos, lpos)
    pdf_v_fwd = bxdf_pdf(mat_v, d_vl, -d_cv, vng, eta) / d_vl.dot(vng).abs()
    pdf_v_rev = bxdf_pdf(mat_v, -d_cv, d_vl, vng, eta) / \
        (-d_cv).dot(vng).abs()
    coscam = d_cv.dot(cfwd).abs()
    d2 = (float(cam.image_plane_dist) / coscam) ** 2
    cam_fwd0 = d2 * cam.film_area_inv / (coscam * coscam)

    one = torch.ones((1,))
    fal = torch.zeros((1,), dtype=torch.bool)
    tru = torch.ones((1,), dtype=torch.bool)
    camv = dict(pos=cpos, ng=cfwd, ns=cfwd, params=None, tp=None,
                fwd=cam_fwd0, rev=one * float(cam.lens_area_inv), g=one,
                delta=fal, valid=tru)
    vv = dict(pos=vpos, ng=vng, ns=vng, params=mat_v, tp=None, fwd=pdf_v_fwd,
              rev=pdf_v_rev, g=geo(cpos, cfwd, vpos, vng), delta=fal,
              valid=tru)
    lv_hit = dict(pos=lpos, ng=lng, ns=lng, params=None, tp=None, fwd=one,
                  rev=one, g=geo(vpos, vng, lpos, lng), delta=fal, valid=tru,
                  light_pick_pdf=pick_pdf)
    lv0 = dict(pos=lpos, ng=lng, ns=lng, params=None, tp=None,
               fwd=one / np.pi, rev=pick_pdf, g=one, delta=fal, valid=tru)
    lv1 = dict(pos=vpos, ng=vng, ns=vng, params=mat_v, tp=None,
               fwd=pdf_v_rev, rev=pdf_v_fwd,
               g=geo(lpos, lng, vpos, vng), delta=fal, valid=tru)

    w03 = float(B.mis_weight(scene, cam, [camv, vv, lv_hit], [lv0], 0, 3,
                             eta)[0])
    w12 = float(B.mis_weight(scene, cam, [camv, vv], [lv0], 1, 2, eta)[0])
    w21 = float(B.mis_weight(scene, cam, [camv], [lv0, lv1], 2, 1, eta)[0])
    np.testing.assert_allclose(w03 + w12 + w21, 1.0, rtol=1e-5)
    assert 0 < w21 < 1 and 0 < w12 < 1 and 0 < w03 < 1
    # the s=0 chain needs the light pick pdf stashed on the vertex
    stashless = {k: v for k, v in lv_hit.items() if k != 'light_pick_pdf'}
    with pytest.raises(KeyError):
        B.mis_weight(scene, cam, [camv, vv, stashless], [lv0], 0, 3, eta)


def test_bdpt_batched_spp_matches_unbatched():
    scene, cam = _diffuse_box(32)
    o1 = RenderOptions(spp=4, bdpt_max_path_length=4)
    o2 = dataclasses.replace(o1, samples_per_launch=4)
    a = B.render(scene, cam, o1, 7)
    b = B.render(scene, cam, o2, 7)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)
    halves = [B.render(scene, cam, dataclasses.replace(o1, spp=2), 7,
                       sample_base=base) for base in (0, 2)]
    torch.testing.assert_close((halves[0] + halves[1]) * 0.5, a,
                               rtol=1e-5, atol=1e-6)


def test_bdpt_strategy_isolation_partitions_render():
    scene, cam = _diffuse_box(12)
    base = dict(spp=2, bdpt_max_path_length=3)
    full = B.render(scene, cam, RenderOptions(**base), 5).numpy()
    parts = [B.render(scene, cam, RenderOptions(bdpt_s_filter=s, **base),
                      5).numpy() for s in range(0, 4)]
    assert np.isfinite(full).all()
    np.testing.assert_allclose(sum(parts), full, rtol=1e-5, atol=1e-6)
    for s, p in enumerate(parts[:3]):
        assert p.sum() > 0, f"s={s} family contributed nothing"


def test_bdpt_unweighted_at_least_full():
    scene, cam = _diffuse_box(12)
    base = dict(spp=2, bdpt_max_path_length=3)
    full = B.render(scene, cam, RenderOptions(**base), 7).numpy()
    unw = B.render(scene, cam, RenderOptions(bdpt_unweighted=True, **base),
                   7).numpy()
    assert np.isfinite(unw).all()
    assert unw.mean() >= full.mean() * (1.0 - 1e-6)
    assert unw.mean() > full.mean() * 1.05


def test_entry_points_serve_bdpt():
    """render_image and the differentiable renderers of the light tracer
    and BDPT run, and their forward values are the integrators' images
    (render_config: tests/test_torch_config.py)."""
    scene, cam = simple_box(8, 6, device="cpu")
    opts = RenderOptions(spp=2, bdpt_max_path_length=3)
    img = render_image(scene, cam, opts, integrator="bdpt", seed=1)
    np.testing.assert_array_equal(img, B.render(scene, cam, opts, 1).numpy())
    params = G.get_params(scene)
    bd = G.render_bdpt_diff(params, scene, cam, opts, seed=1)
    torch.testing.assert_close(bd, B.render(scene, cam, opts, 1), rtol=1e-5,
                               atol=1e-6)
    from tuturenderer_tpu_torch.integrators import light
    lt = G.render_light_diff(params, scene, cam, RenderOptions(spp=2), 1)
    torch.testing.assert_close(
        lt, light.render(scene, cam, RenderOptions(spp=2), 1), rtol=1e-5,
        atol=1e-6)


def test_bdpt_imports_without_jax():
    """integrators/bdpt.py and grad.py import neither jax nor the JAX
    package, and a BDPT render and gradient run without them."""
    code = (
        "import sys\n"
        "import torch\n"
        "import tuturenderer_tpu_torch.integrators.bdpt as B\n"
        "from tuturenderer_tpu_torch import grad as G\n"
        "from tuturenderer_tpu_torch.options import RenderOptions\n"
        "from tuturenderer_tpu_torch.scene.presets import simple_box\n"
        "s, c = simple_box(8, 8, device='cpu')\n"
        "o = RenderOptions(spp=1, bdpt_max_path_length=2)\n"
        "assert bool(torch.isfinite(B.render(s, c, o)).all())\n"
        "p = G.get_params(s)\n"
        "leaves = [a.clone().requires_grad_(True) for a in p.leaves()]\n"
        "img = G.render_bdpt_diff(G.MaterialParams.from_leaves(leaves), s, c,"
        " o)\n"
        "g = torch.autograd.grad(img.mean(), leaves[0])[0]\n"
        "assert bool(torch.isfinite(g).all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tuturenderer_tpu', 'tools')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_bdpt_gradients_match_fd(monkeypatch):
    """tests/test_grad.py's check, on the port (its Moller-Trumbore dense
    form), diffuse and emission only: roughness gradients through BDPT are
    biased in both packages (ROADMAP queue 3)."""
    from test_torch_bdpt_light_grad import image_and_grads
    monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")
    scene, cam = _diffuse_box(32)
    opts = RenderOptions(spp=4, bdpt_max_path_length=4)
    _, grads = image_and_grads(G.render_bdpt_diff, scene, cam, opts, 9)
    assert all(np.isfinite(g).all() for g in grads)
    flat = G.get_params(scene).leaves()

    def fd(leaf, idx, eps):
        def loss(sign):
            fl = [a.clone() for a in flat]
            fl[leaf][idx] += sign * eps
            with torch.no_grad():
                return float(G.render_bdpt_diff(
                    G.MaterialParams.from_leaves(fl), scene, cam, opts,
                    9).double().mean())
        return (loss(1.0) - loss(-1.0)) / (2 * eps)

    assert grads[3][2] != 0.0
    np.testing.assert_allclose(grads[3][2], fd(3, 2, 1e-1), rtol=2e-2)
    assert grads[0][0] != 0.0
    np.testing.assert_allclose(grads[0][0], fd(0, 0, 1e-2), rtol=5e-2)


def test_render_at_length7_matches_stored_jax():
    name = "bdpt-showcase-7"
    stored = np.load(INTEGRATOR_REFS[name])["image"]
    scene, cam = port_scene(INTEGRATOR_CASES[name][1])
    opts = RenderOptions(**integrator_fields(name))
    assert opts.bdpt_max_path_length == RenderOptions().bdpt_max_path_length
    img = B.render(scene, cam, opts, REF_SEED).numpy()
    assert_at_bar(img, stored)
    assert stored.mean() > 0.05
