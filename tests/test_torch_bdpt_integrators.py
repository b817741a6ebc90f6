"""Cross-integrator consistency of the PyTorch port's BDPT: the port forms
of tests/test_integrators.py's BDPT cases, on its open diffuse box (the
JAX package builds the tables, ``scene_from_numpy`` hands them over), at
its sizes, spp, seeds and bars. The port batches samples into wavefronts
(``samples_per_launch``), which changes the schedule only.

- BDPT against PT: within 12 % and below (the reference's MIN_DIVISOR
  weight kill only loses energy);
- with both quirks off and the span/width grid, BDPT at or above PT within
  4 % (PT's own kills lose ~2-3 %);
- the unweighted (s, t) strategies of path length 2 agree within 6 % on
  interior pixels;
- the t=1 gate scales the isolated t=1 strategy by the frame's hit
  fraction (~0.4).

(BDPT's s=0 family against the naive estimator: test_torch_bdpt_naive.py.)
"""
import dataclasses

import numpy as np

from torch_port_util import flatten
from tuturenderer_tpu_torch.camera import camera_from_numpy, make_camera
from tuturenderer_tpu_torch.integrators.bdpt import render as rb
from tuturenderer_tpu_torch.integrators.path import render as rp
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import scene_from_numpy


def _scene():
    from test_grad import diffuse_box
    scene, cam = diffuse_box(48)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


def _np(img):
    img = img.numpy()
    assert np.isfinite(img).all()
    return img


def _span_camera(n: int):
    return make_camera(n, n, 60, eye=(0, 0, -3.2), viewdir=(0, 0, 1),
                       updir=(0, 1, 0), ref_grid=False, device="cpu")


def test_pt_vs_bdpt_mean():
    scene, cam = _scene()
    pt = _np(rp(scene, cam, RenderOptions(spp=32, max_depth=4,
                                          samples_per_launch=8), 1))
    bd = _np(rb(scene, cam, RenderOptions(spp=32, bdpt_max_path_length=6,
                                          samples_per_launch=8), 2))
    rel = abs(pt.mean() - bd.mean()) / pt.mean()
    assert 0.0 < rel < 0.12, f"pt={pt.mean():.4f} bdpt={bd.mean():.4f}"
    assert bd.mean() < pt.mean()


def test_pt_vs_bdpt_parity_quirks_off():
    scene, _ = _scene()
    cam = _span_camera(48)
    pt = _np(rp(scene, cam, RenderOptions(spp=64, max_depth=4,
                                          samples_per_launch=16), 1))
    bd = _np(rb(scene, cam, RenderOptions(
        spp=64, bdpt_max_path_length=6, tutu_bdpt_weight_kill=False,
        tutu_bdpt_t1_gate=False, samples_per_launch=16), 2))
    rel = (bd.mean() - pt.mean()) / pt.mean()
    assert 0.0 < rel < 0.04, \
        f"pt={pt.mean():.4f} bdpt={bd.mean():.4f} rel={rel:+.4f}"


def test_bdpt_unweighted_strategies_agree():
    scene, _ = _scene()
    cam = _span_camera(24)
    imgs = []
    for s in (0, 1, 2):
        imgs.append(_np(rb(scene, cam, RenderOptions(
            spp=512, bdpt_max_path_length=2, bdpt_s_filter=s,
            bdpt_t_filter=3 - s, bdpt_unweighted=True,
            tutu_bdpt_weight_kill=False, tutu_bdpt_t1_gate=False,
            samples_per_launch=128), 11)).mean(-1))
    sup = imgs[1] > 0.02
    er = sup.copy()
    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
        er = er & np.roll(sup, sh, axis=ax)
    er[0, :] = er[-1, :] = er[:, 0] = er[:, -1] = False
    assert er.sum() > 50
    means = [im[er].mean() for im in imgs]
    lo, hi = min(means), max(means)
    assert (hi - lo) / lo < 0.06, f"interior strategy means diverge: {means}"


def test_bdpt_t1_gate_quirk_scales_with_hit_fraction():
    scene, cam = _scene()
    base = RenderOptions(spp=64, bdpt_max_path_length=2, bdpt_s_filter=2,
                         bdpt_t_filter=1, bdpt_unweighted=True,
                         samples_per_launch=16)
    gated = _np(rb(scene, cam, base, 9))
    free = _np(rb(scene, cam, dataclasses.replace(
        base, tutu_bdpt_t1_gate=False), 9))
    ratio = gated.mean() / free.mean()
    assert 0.3 < ratio < 0.55, f"gated/free = {ratio:.3f}"
