"""Mesh-scale presets built from procedural geometry, as in
``tuturenderer_tpu/models/scenes.py``: from 4096 triangles up they carry
cluster tables, so their intersection walks the cluster kernels
(``ops/cuda/cluster.py``). Tensors go on ``device``, the card unless asked
otherwise.
"""
from __future__ import annotations

from ..camera import make_camera
from ..scene.data import LAMBERTIAN, MICROFACET_R, SceneBuilder
from ..utils.device import DEFAULT_DEVICE
from .meshes import heightfield, plane, uv_sphere


def sphere_showcase(width: int = 512, height: int = 512,
                    nu: int = 224, nv: int = 224, device=DEFAULT_DEVICE):
    """A ~100k-triangle smooth sphere on a ground plane under an area
    light: the standard mesh-scale scene."""
    b = SceneBuilder(bkgcolor=(0.05, 0.05, 0.08))
    sphere_mat = b.add_material(MICROFACET_R, diffuse=(0.8, 0.3, 0.2),
                                roughness=0.3, metallic=0.2)
    verts, normals = uv_sphere(radius=1.0, nu=nu, nv=nv)
    b.add_triangles(verts, normals, None, sphere_mat)
    ground = b.add_material(LAMBERTIAN, diffuse=(0.7, 0.7, 0.7))
    # axes ordered so u x v = +y: the plane's geometric normal faces up
    b.add_triangles(plane((0, -1, 0), (0, 0, 6), (6, 0, 0)), None, None,
                    ground)
    light = b.add_material(LAMBERTIAN, emission=(12.0, 11.0, 10.0))
    b.add_triangles(plane((0, 3, 0), (1, 0, 0), (0, 0, 1)), None, None,
                    light)
    scene = b.build(device=device)
    cam = make_camera(width, height, 45, eye=(0, 0.6, -3.5),
                      viewdir=(0, -0.12, 1), updir=(0, 1, 0), device=device)
    return scene, cam


def terrain(width: int = 512, height: int = 512, nx: int = 128,
            nz: int = 128, seed: int = 0, device=DEFAULT_DEVICE):
    """Random smooth terrain (2*nx*nz triangles) under an area light."""
    b = SceneBuilder(bkgcolor=(0.1, 0.12, 0.2))
    ground = b.add_material(LAMBERTIAN, diffuse=(0.55, 0.5, 0.4))
    b.add_triangles(heightfield(nx=nx, nz=nz, seed=seed), None, None,
                    ground)
    light = b.add_material(LAMBERTIAN, emission=(18.0, 17.0, 15.0))
    b.add_triangles(plane((0, 3, 0), (1.5, 0, 0), (0, 0, 1.5)), None, None,
                    light)
    scene = b.build(device=device)
    cam = make_camera(width, height, 50, eye=(0, 1.6, -3.2),
                      viewdir=(0, -0.35, 1), updir=(0, 1, 0), device=device)
    return scene, cam
