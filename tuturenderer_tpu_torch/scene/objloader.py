"""Wavefront OBJ loading with the semantics of the vendored objl loader.

The port of ``tuturenderer_tpu/scene/objloader.py``, host-side numpy. It
re-implements the behaviors of the reference's third-party OBJ_Loader.h
(LoadFile, OBJ_Loader.h:430-717) that matter for scene parity: v/vt/vn/f
parsing, fan triangulation of polygons, negative (relative) indices, and
flat face normals when the file provides none. Materials (mtllib/usemtl)
are ignored like the reference entry points do: every mesh gets the
material passed by the caller (PPMGenerator::loadObj,
PPMGenerator.hpp:164-208).

Only the pure-Python parser is ported; the JAX package's native C++
loader (``native.py``) has no counterpart yet, so ``load_obj`` accepts
``prefer_native`` and ignores it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Mesh:
    """Triangle soup: verts [n,3,3], normals [n,3,3], uvs [n,3,2]."""
    verts: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray

    # --- mesh transforms (PPMGenerator.hpp:210-270 semantics) ---
    def translate(self, x: float, y: float, z: float) -> "Mesh":
        self.verts = self.verts + np.asarray([x, y, z], np.float32)
        return self

    def scale(self, x: float, y: float, z: float) -> "Mesh":
        self.verts = self.verts * np.asarray([x, y, z], np.float32)
        return self

    def rotate(self, axis: int, degree: float) -> "Mesh":
        """axis: 0=x 1=y 2=z, world coords; rotates positions and normals."""
        if degree == 0:
            return self
        r = math.radians(degree)
        c, s = math.cos(r), math.sin(r)
        if axis == 0:
            m = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        elif axis == 1:
            m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        else:
            m = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        self.verts = self.verts @ m.T
        self.normals = self.normals @ m.T
        return self


def _resolve(idx: int, n: int) -> int:
    """OBJ 1-based; negative counts from the end."""
    return idx - 1 if idx > 0 else n + idx


def load_obj(path: str, prefer_native: bool = True) -> Mesh:
    """The mesh of an OBJ file. ``prefer_native`` is accepted for the JAX
    package's signature and ignored: this package has no native loader."""
    return _load_obj_py(path)


def _flat_normals(vs: np.ndarray) -> np.ndarray:
    fn = np.cross(vs[1] - vs[0], vs[2] - vs[0])
    nrm = np.linalg.norm(fn)
    fn = fn / nrm if nrm > 0 else fn
    return np.repeat(fn[None, :], 3, axis=0)


def _load_obj_py(path: str) -> Mesh:
    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    tri_v: List[np.ndarray] = []
    tri_n: List[np.ndarray] = []
    tri_uv: List[np.ndarray] = []

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = _resolve(int(comp[0]), len(positions))
                    ti = ni = -1
                    if len(comp) > 1 and comp[1]:
                        ti = _resolve(int(comp[1]), len(uvs))
                    if len(comp) > 2 and comp[2]:
                        ni = _resolve(int(comp[2]), len(normals))
                    corners.append((vi, ti, ni))
                # fan triangulation (objl triangulates polygons; for convex
                # quads this matches its output order)
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    vs = np.asarray([positions[c[0]] for c in tri],
                                    np.float32)
                    if all(c[2] >= 0 for c in tri):
                        ns = np.asarray([normals[c[2]] for c in tri],
                                        np.float32)
                    else:
                        ns = _flat_normals(vs)
                    if all(c[1] >= 0 for c in tri):
                        ts = np.asarray([uvs[c[1]] for c in tri], np.float32)
                    else:
                        ts = np.full((3, 2), -1.0, np.float32)
                    tri_v.append(vs)
                    tri_n.append(ns)
                    tri_uv.append(ts)

    if tri_v:
        return Mesh(np.stack(tri_v, 0), np.stack(tri_n, 0),
                    np.stack(tri_uv, 0))
    return Mesh(np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 2), np.float32))
