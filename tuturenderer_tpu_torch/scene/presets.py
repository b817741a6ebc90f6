"""Built-in scenes.

``simple_box`` is the self-contained test scene of
``tuturenderer_tpu/scene/presets.py``. The reference's ``cornell_box`` and
``veach_bdpt`` read OBJ assets that are not in the repository; they are
ported once the assets are.
"""
from __future__ import annotations

import numpy as np

from ..camera import make_camera
from .data import (LAMBERTIAN, PERFECT_REFLECTIVE, PERFECT_REFRACTIVE,
                   SceneBuilder)


def simple_box(width: int = 256, height: int = 256, use_bvh=None,
               device="cpu"):
    """A Cornell-like box of explicit quads (12 triangles, an emissive
    quad) plus a mirror and a glass sphere. Returns (scene, camera) with
    tensors on ``device``."""
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
