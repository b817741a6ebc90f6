"""Built-in scenes, the port of ``tuturenderer_tpu/scene/presets.py``.

``cornell_box`` and ``veach_bdpt`` reproduce the reference entry points'
materials, OBJ assets and cameras (src/main_cornellBox.cpp:23-71,
src/main.cpp:24-86). Their model files are read from ``model_dir`` (the
reference's ``model/`` tree), which is not part of this repository.
``simple_box`` is the self-contained test scene.
"""
from __future__ import annotations

import os

import numpy as np

from ..camera import make_camera
from ..utils.device import DEFAULT_DEVICE
from .data import (LAMBERTIAN, MICROFACET_R, PERFECT_REFLECTIVE,
                   PERFECT_REFRACTIVE, SceneBuilder)
from .objloader import load_obj

DEFAULT_MODEL_DIR = "/root/reference/model"


def _add_mesh(b: SceneBuilder, path: str, mat: int):
    m = load_obj(path)
    b.add_triangles(m.verts, m.normals, m.uvs, mat)


def cornell_box(model_dir: str = DEFAULT_MODEL_DIR, width: int = 1024,
                height: int = 1024, device=DEFAULT_DEVICE):
    """Cornell box exactly as src/main_cornellBox.cpp:23-71 + camera from
    configs/config_cornellBox.txt. Returns (scene, camera) on ``device``."""
    d = os.path.join(model_dir, "cornellBox")
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    white = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68))
    light = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                           emission=(47.8348007, 38.5663986, 31.0807991))
    green = b.add_material(LAMBERTIAN, diffuse=(0.14, 0.45, 0.091))
    red = b.add_material(LAMBERTIAN, diffuse=(0.63, 0.065, 0.05))
    _add_mesh(b, os.path.join(d, "floor.obj"), white)
    _add_mesh(b, os.path.join(d, "light.obj"), light)
    _add_mesh(b, os.path.join(d, "right.obj"), green)
    _add_mesh(b, os.path.join(d, "left.obj"), red)
    _add_mesh(b, os.path.join(d, "tallbox.obj"), white)
    _add_mesh(b, os.path.join(d, "shortbox.obj"), white)
    scene = b.build(device=device)
    cam = make_camera(width, height, 40, eye=(278, 273, -800),
                      viewdir=(0, 0, 1), updir=(0, 1, 0), device=device)
    return scene, cam


def veach_bdpt(model_dir: str = DEFAULT_MODEL_DIR, width: int = 800,
               height: int = 600, device=DEFAULT_DEVICE):
    """Veach BDPT room exactly as src/main.cpp:24-86 + camera from
    configs/config_veach_bdpt.txt. (The reference's lowercase
    ``veach_slight.obj`` path only works on case-insensitive filesystems,
    main.cpp:49; the real file name, ``veach_sLight.obj``, is used here.)
    Returns (scene, camera) on ``device``."""
    d = os.path.join(model_dir, "veach_bdpt")
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    room = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68))
    llight = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                            emission=(250.0, 250.0, 250.0))
    slight = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                            emission=(6999.999881 * 0.5, 5450.000167 * 0.5,
                                      3630.000055 * 0.5))
    table = b.add_material(LAMBERTIAN, diffuse=(0.32962962985,
                                                0.257976263762,
                                                0.150291711092))
    glass = b.add_material(PERFECT_REFRACTIVE, eta=1.5)
    tall_lamp = b.add_material(MICROFACET_R, roughness=0.2775146484375,
                               metallic=0.5,
                               diffuse=(0.32962962985, 0.257976263762,
                                        0.150291711092))
    _add_mesh(b, os.path.join(d, "veach_room.obj"), room)
    _add_mesh(b, os.path.join(d, "veach_Llight.obj"), llight)
    _add_mesh(b, os.path.join(d, "veach_sLight.obj"), slight)
    _add_mesh(b, os.path.join(d, "veach_table.obj"), table)
    _add_mesh(b, os.path.join(d, "veach_glass.obj"), glass)
    _add_mesh(b, os.path.join(d, "veach_tallLamp.obj"), tall_lamp)
    _add_mesh(b, os.path.join(d, "veach_wallLamp.obj"), room)
    scene = b.build(device=device)
    cam = make_camera(width, height, 40, eye=(-0.5, 0, 7.6),
                      viewdir=(-0.005, 0, -1), updir=(0, 1, 0), device=device)
    return scene, cam


def simple_box(width: int = 256, height: int = 256, use_bvh=None,
               device=DEFAULT_DEVICE):
    """A Cornell-like box of explicit quads (12 triangles, an emissive
    quad) plus a mirror and a glass sphere. Returns (scene, camera) with
    tensors on ``device``, the card unless asked otherwise."""
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    white = b.add_material(LAMBERTIAN, diffuse=(0.73, 0.73, 0.73))
    red = b.add_material(LAMBERTIAN, diffuse=(0.65, 0.05, 0.05))
    green = b.add_material(LAMBERTIAN, diffuse=(0.12, 0.45, 0.15))
    light = b.add_material(LAMBERTIAN, diffuse=(0.73, 0.73, 0.73),
                           emission=(30.0, 30.0, 30.0))
    mirror = b.add_material(PERFECT_REFLECTIVE)
    glass = b.add_material(PERFECT_REFRACTIVE, eta=1.5)

    def quad(p0, p1, p2, p3, mat):
        v = np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32)
        b.add_triangles(v, None, None, mat)

    # windings chosen so geometric normals point into the box
    s = 1.0
    quad((-s, -s, -s), (-s, -s, s), (s, -s, s), (s, -s, -s), white)   # floor +y
    quad((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s), white)       # ceiling -y
    quad((-s, -s, s), (-s, s, s), (s, s, s), (s, -s, s), white)       # back -z
    quad((-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s), red)     # left +x
    quad((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s), green)       # right -x
    q = 0.35
    quad((-q, s - 1e-3, -q), (q, s - 1e-3, -q), (q, s - 1e-3, q),
         (-q, s - 1e-3, q), light)                                    # light -y
    b.add_sphere((-0.45, -0.6, 0.2), 0.4, mirror)
    b.add_sphere((0.45, -0.6, -0.2), 0.4, glass)
    scene = b.build(use_bvh=use_bvh, device=device)
    cam = make_camera(width, height, 60, eye=(0, 0, -3.6),
                      viewdir=(0, 0, 1), updir=(0, 1, 0), device=device)
    return scene, cam
