"""The ``tetra`` database of Eric Haines' Standard Procedural Databases.

Haines, "A Proposal for Standard Graphics Environments", IEEE Computer
Graphics and Applications 7(11), 1987. ``tetra`` is a Sierpinski
tetrahedron: level 0 is one regular tetrahedron, and each level replaces
every tetrahedron by the four half-size tetrahedra at its corners, each
spanned by one of its vertices and the midpoints of the three edges at that
vertex (they touch only at points). At the SPD's size factor SF that is
4^SF tetrahedra, and with four flat faces each, 4^(SF + 1) triangles.

Nothing here comes from a file: the recursion defines the geometry, so this
generator builds it exactly (in float64, then rounded once to float32).
The level-0 tetrahedron stands on its base: the base is an equilateral
triangle in the plane y = ``base_y`` centred on (x, z) = ``center``, its
first corner towards -z, and the apex straight above the centre. Each
face is wound so that its normal (v1 - v0) x (v2 - v0) points away from
the tetrahedron. This module imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

# the face opposite vertex k of a tetrahedron (v0, v1, v2, v3)
FACES = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]])


def level0(edge: float, center=(0.0, 0.0), base_y: float = 0.0):
    """The regular tetrahedron of edge ``edge`` -> [4, 3] float64: three
    base corners, then the apex."""
    r = edge / np.sqrt(3.0)                 # the base's circumradius
    h = edge * np.sqrt(2.0 / 3.0)           # the apex's height
    ang = np.radians([270.0, 30.0, 150.0])  # -z first, counter-clockwise
    cx, cz = center
    base = np.stack([cx + r * np.cos(ang), np.full(3, float(base_y)),
                     cz + r * np.sin(ang)], axis=1)
    apex = np.array([[cx, base_y + h, cz]])
    return np.concatenate([base, apex], 0)


def subdivide(tets: np.ndarray) -> np.ndarray:
    """[n, 4, 3] -> [4n, 4, 3]: tetrahedron k's child c (at index 4k + c)
    keeps vertex c and puts the midpoint of edge (c, j) in slot j, a copy
    of its parent scaled by 1/2 about vertex c."""
    mid = 0.5 * (tets[:, :, None, :] + tets[:, None, :, :])  # [n, 4, 4, 3]
    return mid.reshape(-1, 4, 3)


def tetrahedra(size_factor: int, edge: float, center=(0.0, 0.0),
               base_y: float = 0.0) -> np.ndarray:
    """The 4^size_factor tetrahedra of level ``size_factor`` -> [n, 4, 3]
    float64."""
    if size_factor < 0:
        raise ValueError(f"size_factor {size_factor} < 0")
    tets = level0(edge, center, base_y)[None]
    for _ in range(size_factor):
        tets = subdivide(tets)
    return tets


def faces(tets: np.ndarray) -> np.ndarray:
    """The four faces of each tetrahedron, wound outward -> [4n, 3, 3]
    float64, tetrahedron by tetrahedron, face k opposite vertex k."""
    tri = tets[:, FACES]                                     # [n, 4, 3, 3]
    normal = np.cross(tri[..., 1, :] - tri[..., 0, :],
                      tri[..., 2, :] - tri[..., 0, :])
    inward = np.einsum("nki,nki->nk", normal,
                       tets - tri[..., 0, :]) > 0.0
    tri[inward] = tri[inward][:, ::-1]
    return tri.reshape(-1, 3, 3)


def tetra_triangles(shape: dict) -> np.ndarray:
    """The triangles of a configuration's ``{"spd_tetra": {...}}`` shape
    (keys ``size_factor``, ``edge``, ``center`` [x, z], ``base_y``) ->
    [4^(SF + 1), 3, 3] float32."""
    tets = tetrahedra(int(shape["size_factor"]), float(shape["edge"]),
                      tuple(shape["center"]), float(shape["base_y"]))
    return faces(tets).astype(np.float32)
