"""3-vector math over structure-of-arrays torch tensors.

``Vec3`` is a NamedTuple of three same-shaped tensors (or 0-d tensors for
scene constants) with elementwise algebra, as in
``tuturenderer_tpu/utils/vec.py``. The port keeps the SoA layout at its
public functions so both packages compare column by column.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor
_F32_TINY = float(np.finfo(np.float32).tiny)   # smallest normal float32


class Vec3(NamedTuple):
    x: Tensor
    y: Tensor
    z: Tensor

    # ---- algebra ----
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ----
    def dot(self, o: "Vec3") -> Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self) -> Tensor:
        return self.dot(self)

    def norm(self) -> Tensor:
        return torch.sqrt(self.norm2())

    def normalized(self, eps: float = 0.0) -> "Vec3":
        if eps:
            # a floor below float32's normal range is 0, as on the JAX
            # package's backends, which flush subnormals: a zero vector
            # then normalizes to NaN in both packages
            floor = eps * eps if eps * eps >= _F32_TINY else 0.0
            inv = torch.rsqrt(torch.clamp(self.norm2(), min=floor))
        else:
            inv = 1.0 / self.norm()
        return self * inv

    def max_component(self) -> Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def abs(self) -> "Vec3":
        return Vec3(self.x.abs(), self.y.abs(), self.z.abs())

    # ---- structural ----
    def astype(self, dtype: torch.dtype) -> "Vec3":
        return Vec3(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))

    def stack(self, dim: int = -1) -> Tensor:
        """Materialize as a dense [..., 3] tensor (host/IO boundary only)."""
        return torch.stack([self.x, self.y, self.z], dim=dim)

    @property
    def shape(self):
        return tuple(np.shape(self.x))


def vec3(x, y=None, z=None, device=None) -> Vec3:
    if y is None:
        y = x
        z = x
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Vec3(f(x), f(y), f(z))


def from_stacked(a: Tensor) -> Vec3:
    """[..., 3] dense tensor -> Vec3 (host/IO boundary only)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def where(mask: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def select_scalar(mask: Tensor, a, b) -> Tensor:
    return torch.where(mask, a, b)


def lerp(v0: Vec3, v1: Vec3, t) -> Vec3:
    """v0 + t * (v1 - v0)  (reference global.hpp:39-50 semantics)."""
    return v0 + (v1 - v0) * t


def reflect(incident: Vec3, n: Vec3) -> Vec3:
    """Mirror direction 2(N.I)N - I; ``incident`` points away from the
    surface (getReflectionDir, global.hpp:264-269)."""
    return n * (2.0 * n.dot(incident)) - incident


def refract(incident: Vec3, n: Vec3, eta_i, eta_t):
    """Transmitted direction (getRefractionDir, global.hpp:272-301).
    Returns (dir, tir); the direction is zero where ``tir`` is True."""
    cos_i = torch.clamp(n.dot(incident), -1.0, 1.0)
    flip = cos_i < 0.0
    n = where(flip, -n, n)
    cos_i = cos_i.abs()
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = (eta_i / eta_t) * sin_i
    tir = sin_i > (eta_t / eta_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    d = (-n) * cos_t + (n * cos_i - incident) * (eta_i / eta_t)
    zero = torch.zeros_like(d.x)
    d = where(tir, Vec3(zero, zero, zero), d)
    return d, tir


def orthonormal_basis(n: Vec3):
    """(s, t) completing unit normal ``n`` to an ONB: helper axis +y when
    |n.x| > 0.9 else +x (SphereLocal2world, global.hpp:387-410)."""
    big = n.x.abs() > 0.9
    ax = torch.where(big, 0.0, 1.0).to(n.x.dtype)
    ay = torch.where(big, 1.0, 0.0).to(n.x.dtype)
    a = Vec3(ax, ay, torch.zeros_like(ax))
    s = n.cross(a).normalized(1e-20)
    t = n.cross(s)
    return s, t


def local_to_world(n: Vec3, local: Vec3) -> Vec3:
    """Map ``local`` (z-up) into the hemisphere frame of unit normal ``n``,
    with the reference's final normalize (global.hpp:387-410)."""
    s, t = orthonormal_basis(n)
    return (s * local.x + t * local.y + n * local.z).normalized(1e-20)
