"""Pinhole camera: host-side construction and primary rays.

The camera model of ``tuturenderer_tpu/camera.py`` (Camera.hpp:12-48, image
plane setup PathTracing.hpp:357-391): the host computes the plane corners
and steps in float64 and the device functions read them as float32 tensors.
The raster/importance functions (``world_to_raster``,
``world_to_pixel_index``, ``importance_we``) serve light tracing and come
with it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .utils.device import DEFAULT_DEVICE, resolve
from .utils.vec import Vec3, vec3


def _normalized(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _perspective_matrix(hfov_deg: float, near: float, far: float,
                        aspect: float) -> np.ndarray:
    """Row-major 4x4 perspective; mirrors Vector.hpp:352-373 (incl. the
    y-flip in orth_scale row 1)."""
    p2o = np.zeros((4, 4), np.float64)
    p2o[0, 0] = near
    p2o[1, 1] = near
    p2o[2, 2] = near + far
    p2o[2, 3] = near * far
    p2o[3, 2] = -1.0
    r = math.tan(math.radians(hfov_deg / 2.0)) * near
    l = -r
    t = r / aspect
    b = -t
    orth_trans = np.array(
        [[1, 0, 0, -(r + l) / 2],
         [0, 1, 0, -(t + b) / 2],
         [0, 0, 1, -(near + far) / 2],
         [0, 0, 0, 1]], np.float64)
    orth_scale = np.array(
        [[2 / (r - l), 0, 0, 0],
         [0, 2 / -(t - b), 0, 0],
         [0, 0, 2 / (near - far), 0],
         [0, 0, 0, 1]], np.float64)
    return orth_scale @ orth_trans @ p2o


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Vec3
    fwd: Vec3
    up: Vec3
    right: Vec3
    ul: Vec3          # upper-left image-plane corner
    delta_h: Vec3
    delta_v: Vec3
    c_off: Vec3       # c_off_h + c_off_v combined
    world2raster: torch.Tensor  # [4,4] f32
    image_plane_dist: torch.Tensor
    film_area_inv: torch.Tensor
    lens_area_inv: torch.Tensor
    width: int
    height: int
    hfov: float
    parallel_projection: bool

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def make_camera(width: int, height: int, hfov: float, eye, viewdir, updir,
                parallel_projection: bool = False,
                ref_grid: bool = True, device=DEFAULT_DEVICE) -> Camera:
    """Host-side camera construction (Camera.hpp:12-48 + plane setup
    PathTracing.hpp:357-391). ``ref_grid=True`` reproduces the reference's
    pixel grid, which steps (ur-ul)/(width-1) (PathTracing.hpp:381-383);
    ``ref_grid=False`` steps span/width. Tensors on ``device``."""
    device = resolve(device)
    eye = np.asarray(eye, np.float64)
    fwd = _normalized(np.asarray(viewdir, np.float64))
    up_in = np.asarray(updir, np.float64)
    right = _normalized(np.cross(fwd, up_in))
    up = _normalized(np.cross(right, fwd))

    # world2cam (Camera.hpp:20-35): rows right/up/-fwd with projected eye
    pos_cam = np.array([right @ eye, up @ eye, (-fwd) @ eye])
    world2cam = np.zeros((4, 4), np.float64)
    world2cam[0, :3] = right
    world2cam[0, 3] = -pos_cam[0]
    world2cam[1, :3] = up
    world2cam[1, 3] = -pos_cam[1]
    world2cam[2, :3] = -fwd
    world2cam[2, 3] = -pos_cam[2]
    world2cam[3, 3] = 1.0

    persp = _perspective_matrix(hfov, 0.1, 10000.0, width / height)
    world2ndc = persp @ world2cam
    translate = np.eye(4)
    translate[0, 3] = 1.0
    translate[1, 3] = 1.0
    scale = np.diag([width * 0.5, height * 0.5, 0.0, 1.0])
    world2raster = scale @ (translate @ world2ndc)

    tan_half = math.tan(math.radians(hfov * 0.5))
    d = width / (2.0 * tan_half)          # pixel area == 1 (Camera.hpp:43-44)
    d_plane = 4.0 if parallel_projection else d   # PathTracing.hpp:368

    # image plane corners (PathTracing.hpp:373-391)
    width_half = abs(tan_half * d_plane)
    aspect = width / height
    height_half = width_half / aspect
    ul = eye + d_plane * fwd - width_half * right + height_half * up
    ur = eye + d_plane * fwd + width_half * right + height_half * up
    ll = eye + d_plane * fwd - width_half * right - height_half * up
    if ref_grid:
        dh = (ur - ul) / (width - 1) if width != 1 else np.zeros(3)
        dv = (ll - ul) / (height - 1) if height != 1 else np.zeros(3)
    else:
        dh = (ur - ul) / width
        dv = (ll - ul) / height
    c_off = (ur - ul) / (2.0 * width) + (ll - ul) / (2.0 * height)

    f32 = lambda a: vec3(*np.asarray(a, np.float32), device=device)
    scalar = lambda a: torch.tensor(np.float32(a), device=device)
    return Camera(
        position=f32(eye), fwd=f32(fwd), up=f32(up), right=f32(right),
        ul=f32(ul), delta_h=f32(dh), delta_v=f32(dv), c_off=f32(c_off),
        world2raster=torch.as_tensor(world2raster.astype(np.float32),
                                     device=device),
        image_plane_dist=scalar(d),
        film_area_inv=scalar(1.0 / (width * height)),
        lens_area_inv=scalar(1.0),
        width=width, height=height, hfov=float(hfov),
        parallel_projection=bool(parallel_projection),
    )


_CAMERA_STATIC = ("width", "height", "hfov", "parallel_projection")


def camera_from_numpy(arrays: dict, device=DEFAULT_DEVICE) -> Camera:
    """Camera from the JAX ``Camera`` fields flattened to numpy: Vec3
    fields under dotted keys (``position.x``), ``world2raster`` and the
    scalars under their names, and the static fields ``width``, ``height``,
    ``hfov`` and ``parallel_projection`` as numpy scalars."""
    device = resolve(device)
    kw = {}
    for f in dataclasses.fields(Camera):
        if f.name in _CAMERA_STATIC:
            continue
        if f.name in arrays:
            kw[f.name] = torch.from_numpy(np.array(arrays[f.name])).to(device)
        else:
            kw[f.name] = Vec3(*(torch.from_numpy(
                np.array(arrays[f"{f.name}.{c}"])).to(device)
                for c in "xyz"))
    return Camera(**kw, width=int(arrays["width"]),
                  height=int(arrays["height"]), hfov=float(arrays["hfov"]),
                  parallel_projection=bool(arrays["parallel_projection"]))


def pixel_position(cam: Camera, px, py, jx=None, jy=None) -> Vec3:
    """World-space point on the image plane for pixel (px, py): the pixel
    center, or a jittered point with jx/jy in [0, 1)."""
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    if jx is not None:
        fx = fx + (jx - 0.5)
        fy = fy + (jy - 0.5)
    return cam.ul + cam.delta_h * fx + cam.delta_v * fy + cam.c_off


def primary_ray(cam: Camera, px, py, jx=None, jy=None):
    """Returns (origin Vec3[N], dir Vec3[N], pixel_pos Vec3[N])."""
    p = pixel_position(cam, px, py, jx, jy)
    zeros = torch.zeros_like(p.x)
    if cam.parallel_projection:
        d = cam.fwd
        rdir = Vec3(zeros + d.x, zeros + d.y, zeros + d.z)
        orig = p - rdir * 4.0              # PathTracing.hpp:455
        return orig, rdir, p
    rdir = (p - cam.position).normalized()
    orig = Vec3(zeros + cam.position.x, zeros + cam.position.y,
                zeros + cam.position.z)
    return orig, rdir, p
