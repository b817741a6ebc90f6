"""Pinhole camera: host-side construction and primary rays.

The camera model of ``tuturenderer_tpu/camera.py`` (Camera.hpp:12-48, image
plane setup PathTracing.hpp:357-391): the host computes the plane corners
and steps in float64 and the device functions read them as float32 tensors.
The world->raster chain world2Cam -> perspective(near=0.1, far=1e4) ->
translate(1,1,0) -> scale(w/2, h/2) (Camera.hpp:32-40, Vector.hpp:352-373)
serves the light-tracing splats and the camera importance ``We``
(IIntegrator.hpp:233-248): ``world_to_raster``, ``world_to_pixel_index``
and ``importance_we``.
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


def world_to_raster(cam: Camera, pos: Vec3):
    """Project world point -> (raster_x, raster_y) after perspective divide,
    with the -0.5 shift from Camera.hpp:60-66."""
    m = cam.world2raster
    x = m[0, 0] * pos.x + m[0, 1] * pos.y + m[0, 2] * pos.z + m[0, 3]
    y = m[1, 0] * pos.x + m[1, 1] * pos.y + m[1, 2] * pos.z + m[1, 3]
    w = m[3, 0] * pos.x + m[3, 1] * pos.y + m[3, 2] * pos.z + m[3, 3]
    inv_w = 1.0 / w
    return x * inv_w - 0.5, y * inv_w - 0.5


def world_to_pixel_index(cam: Camera, pos: Vec3):
    """Flat pixel index (int32) for a world point; -1 when outside the
    frustum (Camera.hpp:51-78).

    Bounds are checked on the TRUNCATED ints, exactly like the C code
    (``int x = (int)raster.x; if (x < 0 ...)``, Camera.hpp:52-55): the cast
    truncates toward zero, so raster values in (-1, 0) fold onto row/column
    0 and are accepted. A non-finite raster coordinate gives -1: casting one
    to int is undefined in C and differs between XLA, torch on the CPU and
    torch on CUDA (XLA on the CPU and CUDA turn NaN into 0, an accepted
    column)."""
    rx, ry = world_to_raster(cam, pos)
    finite = torch.isfinite(rx) & torch.isfinite(ry)
    ix = torch.where(finite, rx, -1.0).to(torch.int32)
    iy = torch.where(finite, ry, -1.0).to(torch.int32)
    inside = finite & (ix >= 0) & (ix < cam.width) & (iy >= 0) & \
        (iy < cam.height)
    return torch.where(inside, ix + cam.width * iy, -1)


def importance_we(cam: Camera, pos: Vec3):
    """Camera importance function We (IIntegrator.hpp:233-248): zero outside
    the frustum, else d_pixel^2 / (lensArea * filmArea * cos^2). Returns
    (We, pixel index)."""
    idx = world_to_pixel_index(cam, pos)
    to_cam = Vec3(cam.position.x - pos.x, cam.position.y - pos.y,
                  cam.position.z - pos.z).normalized(1e-20)
    cos_cam = cam.fwd.dot(-to_cam).abs()
    dist = cam.image_plane_dist / torch.clamp(cos_cam, min=1e-20)
    we = dist * dist * cam.lens_area_inv * cam.film_area_inv / \
        torch.clamp(cos_cam * cos_cam, min=1e-20)
    return torch.where(idx >= 0, we, 0.0), idx
