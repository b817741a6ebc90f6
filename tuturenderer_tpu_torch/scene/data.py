"""Scene-as-tensors: the device-side scene representation.

The same flat structure-of-arrays tables as ``tuturenderer_tpu/scene/data.py``
(triangles ``[T]``, spheres ``[S]``, a material table ``[M]``, texture
atlases and a light table), as torch tensors on one device.

Two ways in:

- ``SceneBuilder`` assembles a scene on the host in numpy, exactly as the
  JAX builder does (the float64 Woop factorisation included), and emits
  tensors on the ``device`` given to ``build``;
- ``scene_from_numpy`` takes the JAX ``SceneData`` fields already flattened
  to numpy (dotted keys for nested fields, e.g. ``materials.diffuse.x``), so
  one built scene feeds both packages.

Scenes with BVH or cluster tables (4096 triangles and more, or
``use_bvh=True``) are not served yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..utils.vec import Vec3

# material type enum (Material.hpp:9-16)
LAMBERTIAN = 0
PERFECT_REFLECTIVE = 1
PERFECT_REFRACTIVE = 2
MICROFACET_R = 3
MICROFACET_T = 4
UNLIT = 5

TRIANGLE = 0
SPHERE = 1

# the dense-streaming limit (tuturenderer_tpu/ops/bvh.py BVH_THRESHOLD):
# from here up the JAX package attaches BVH and cluster tables
BVH_THRESHOLD = 4096
_CLUSTER_SCENES = ("scenes with BVH/cluster tables (>= 4096 triangles or "
                   "use_bvh=True) come with ROADMAP queue 1 item 10")


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    mtype: torch.Tensor        # [M] int32
    diffuse: Vec3              # [M]
    specular: Vec3             # [M]
    emission: Vec3             # [M]
    alpha: torch.Tensor        # [M] opacity
    eta: torch.Tensor          # [M] index of refraction
    roughness: torch.Tensor    # [M]
    metallic: torch.Tensor     # [M]
    diffuse_map: torch.Tensor  # [M] int32, -1 = none
    normal_map: torch.Tensor
    roughness_map: torch.Tensor
    metallic_map: torch.Tensor

    @property
    def n(self) -> int:
        return self.mtype.shape[0]


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """Fixed-size-padded stack of textures of one category: ``rgb`` is
    [K, Hmax, Wmax, 3]; per-texture true sizes in ``w``/``h``."""
    rgb: torch.Tensor   # [K, Hmax, Wmax, 3] f32
    w: torch.Tensor     # [K] int32
    h: torch.Tensor     # [K] int32

    @property
    def k(self) -> int:
        return self.rgb.shape[0]

    def sample(self, idx, u, v) -> Vec3:
        """Nearest-neighbor sample with repeat wrap (Texture.hpp:18-39);
        idx < 0 returns zeros."""
        safe = torch.clamp(idx, min=0).long()
        # repeat wrap (Texture.hpp:22-29): u>0 -> frac(u); u<=0 -> 1-frac(|u|)
        uw = torch.where(u > 0, u - torch.floor(u),
                         1.0 - (u.abs() - torch.floor(u.abs())))
        vw = torch.where(v > 0, v - torch.floor(v),
                         1.0 - (v.abs() - torch.floor(v.abs())))
        tw = self.w[safe]
        th = self.h[safe]
        x = torch.minimum(torch.clamp((uw * tw).to(torch.int32), min=0),
                          tw - 1).long()
        y = torch.minimum(torch.clamp((vw * th).to(torch.int32), min=0),
                          th - 1).long()
        texel = self.rgb[safe, y, x]     # [N, 3] gather
        texel = torch.where((idx >= 0)[..., None], texel, 0.0)
        return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])


@dataclasses.dataclass(frozen=True)
class SceneData:
    # triangles [T]
    tv0: Vec3
    tv1: Vec3
    tv2: Vec3
    tn0: Vec3
    tn1: Vec3
    tn2: Vec3
    tuv0u: torch.Tensor
    tuv0v: torch.Tensor
    tuv1u: torch.Tensor
    tuv1v: torch.Tensor
    tuv2u: torch.Tensor
    tuv2v: torch.Tensor
    tmat: torch.Tensor        # [T] int32 material id
    tarea: torch.Tensor       # [T] f32
    # packed per-triangle shading row [T, 20]: n0(3) n1(3) n2(3) ng(3)
    # uv0(2) uv1(2) uv2(2) mat(1,f32) area(1)
    tri_shade: torch.Tensor
    # packed per-triangle tangent frame [T, 6]: tangent(3) bitangent(3)
    tri_tbn: torch.Tensor
    # spheres [S]
    scenter: Vec3
    sradius: torch.Tensor
    smat: torch.Tensor
    sarea: torch.Tensor
    # materials
    materials: MaterialTable
    # lights [L]
    light_kind: torch.Tensor  # [L] int32 TRIANGLE/SPHERE
    light_idx: torch.Tensor   # [L] int32 into tri/sphere arrays
    light_area: torch.Tensor  # [L] f32
    light_v0: Vec3            # [L] triangle-light geometry
    light_v1: Vec3
    light_v2: Vec3
    light_n0: Vec3
    light_n1: Vec3
    light_n2: Vec3
    light_emission: Vec3      # [L] resolved material emission
    # textures
    diffuse_maps: TextureAtlas
    normal_maps: TextureAtlas
    roughness_maps: TextureAtlas
    metallic_maps: TextureAtlas
    # globals
    bkgcolor: Vec3            # Vec3 of 0-d tensors
    eta: torch.Tensor         # scene index of refraction (0-d)
    # Woop triangle transform: rows of the inverse [e1 e2 n] basis,
    # factorised in float64 on the host. woop_w [3, 3T]; woop_c [3T]
    # (row . v0 offsets); woop_nlen [T] (|n|)
    woop_w: torch.Tensor
    woop_c: torch.Tensor
    woop_nlen: torch.Tensor
    # static metadata
    has_textures: bool
    mtype_set: tuple

    @property
    def n_tris(self) -> int:
        return self.tmat.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.smat.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tarea.device


def _check_dense(n_tris: int):
    if n_tris >= BVH_THRESHOLD:
        raise NotImplementedError(
            f"{n_tris} triangles: {_CLUSTER_SCENES}")


def _stack_textures(textures: List[np.ndarray], device) -> TextureAtlas:
    if not textures:
        return TextureAtlas(
            rgb=torch.zeros((1, 1, 1, 3), dtype=torch.float32, device=device),
            w=torch.ones((1,), dtype=torch.int32, device=device),
            h=torch.ones((1,), dtype=torch.int32, device=device))
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    k = len(textures)
    rgb = np.zeros((k, hmax, wmax, 3), np.float32)
    w = np.zeros((k,), np.int32)
    h = np.zeros((k,), np.int32)
    for i, t in enumerate(textures):
        h[i], w[i] = t.shape[0], t.shape[1]
        rgb[i, :h[i], :w[i]] = t
    return TextureAtlas(rgb=_tensor(rgb, device), w=_tensor(w, device),
                        h=_tensor(h, device))


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)    # a writable copy


class SceneBuilder:
    """Host-side scene assembly, the same as the JAX package's builder
    (PPMGenerator.hpp:33-72 plus Scene::add, Scene.hpp:20-26); ``build``
    emits torch tensors on the given device."""

    def __init__(self, bkgcolor=(0.0, 0.0, 0.0), eta: float = 1.0,
                 tutu_sphere_area: bool = False):
        self.bkgcolor = np.asarray(bkgcolor, np.float32)
        self.eta = float(eta)
        self.tutu_sphere_area = tutu_sphere_area
        self._mat = dict(mtype=[], diffuse=[], specular=[], emission=[],
                         alpha=[], eta=[], roughness=[], metallic=[],
                         dmap=[], nmap=[], rmap=[], mmap=[])
        self._mat_dedup = {}
        self._tris: List[np.ndarray] = []   # each [n, 3, 3] verts
        self._tri_normals: List[np.ndarray] = []
        self._tri_uvs: List[np.ndarray] = []
        self._tri_mat: List[np.ndarray] = []
        self._sph_center: List[np.ndarray] = []
        self._sph_radius: List[float] = []
        self._sph_mat: List[int] = []
        self.textures = dict(diffuse=[], normal=[], roughness=[], metallic=[])
        self._texture_names = dict(diffuse={}, normal={}, roughness={},
                                   metallic={})

    # ---- materials ----
    def add_material(self, mtype=LAMBERTIAN, diffuse=(0.9, 0.9, 0.9),
                     specular=(1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0),
                     alpha=1.0, eta=1.0, roughness=1.0, metallic=0.0,
                     diffuse_map=-1, normal_map=-1, roughness_map=-1,
                     metallic_map=-1) -> int:
        key = (int(mtype), tuple(np.ravel(diffuse).tolist()),
               tuple(np.ravel(specular).tolist()),
               tuple(np.ravel(emission).tolist()),
               float(alpha), float(eta), float(roughness), float(metallic),
               int(diffuse_map), int(normal_map), int(roughness_map),
               int(metallic_map))
        if key in self._mat_dedup:
            return self._mat_dedup[key]
        m = self._mat
        m['mtype'].append(int(mtype))
        m['diffuse'].append(np.asarray(diffuse, np.float32))
        m['specular'].append(np.asarray(specular, np.float32))
        m['emission'].append(np.asarray(emission, np.float32))
        m['alpha'].append(float(alpha))
        m['eta'].append(float(eta))
        m['roughness'].append(float(roughness))
        m['metallic'].append(float(metallic))
        m['dmap'].append(int(diffuse_map))
        m['nmap'].append(int(normal_map))
        m['rmap'].append(int(roughness_map))
        m['mmap'].append(int(metallic_map))
        idx = len(m['mtype']) - 1
        self._mat_dedup[key] = idx
        return idx

    def add_texture(self, category: str, name: str, rgb: np.ndarray) -> int:
        """Dedup-by-name texture registration (PPMGenerator.hpp:1027-1033)."""
        names = self._texture_names[category]
        if name in names:
            return names[name]
        idx = len(self.textures[category])
        self.textures[category].append(np.asarray(rgb, np.float32))
        names[name] = idx
        return idx

    # ---- geometry ----
    def add_triangles(self, verts: np.ndarray, normals: Optional[np.ndarray],
                      uvs: Optional[np.ndarray], material: int):
        """verts [n,3,3]; normals [n,3,3] or None (-> face normals);
        uvs [n,3,2] or None."""
        verts = np.asarray(verts, np.float32)
        n = verts.shape[0]
        if n == 0:
            return
        if normals is None:
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            fn = np.cross(e1, e2)
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True),
                                 1e-20)
            normals = np.repeat(fn[:, None, :], 3, axis=1)
        if uvs is None:
            uvs = np.full((n, 3, 2), -1.0, np.float32)
        self._tris.append(verts)
        self._tri_normals.append(np.asarray(normals, np.float32))
        self._tri_uvs.append(np.asarray(uvs, np.float32))
        self._tri_mat.append(np.full((n,), material, np.int32))

    def add_sphere(self, center, radius: float, material: int):
        self._sph_center.append(np.asarray(center, np.float32))
        self._sph_radius.append(float(radius))
        self._sph_mat.append(int(material))

    # ---- build ----
    def build(self, use_bvh=None, device="cpu") -> SceneData:
        """Tensors on ``device``. ``use_bvh=True``, or None with 4096
        triangles or more, asks for BVH/cluster tables, which this package
        does not build yet: it raises."""
        if self._tris:
            verts = np.concatenate(self._tris, 0)
            normals = np.concatenate(self._tri_normals, 0)
            uvs = np.concatenate(self._tri_uvs, 0)
            tmat = np.concatenate(self._tri_mat, 0)
        else:
            verts = np.zeros((0, 3, 3), np.float32)
            normals = np.zeros((0, 3, 3), np.float32)
            uvs = np.zeros((0, 3, 2), np.float32)
            tmat = np.zeros((0,), np.int32)
        if use_bvh:
            raise NotImplementedError(f"use_bvh=True: {_CLUSTER_SCENES}")
        _check_dense(verts.shape[0])
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        tcross = np.cross(e1, e2)
        tarea = 0.5 * np.linalg.norm(tcross, axis=1)
        tng = tcross / np.maximum(
            np.linalg.norm(tcross, axis=1, keepdims=True), 1e-30)
        tri_shade = np.concatenate([
            normals.reshape(-1, 9), tng.astype(np.float32),
            uvs.reshape(-1, 6), tmat[:, None].astype(np.float32),
            tarea[:, None].astype(np.float32)], axis=1).astype(np.float32)
        # UV-delta tangent frame (changeNormalDir triangle branch,
        # IIntegrator.hpp:45-56)
        e1f = e1.astype(np.float32)
        e2f = e2.astype(np.float32)
        du1 = (uvs[:, 1, 0] - uvs[:, 0, 0]).astype(np.float32)
        dv1 = (uvs[:, 1, 1] - uvs[:, 0, 1]).astype(np.float32)
        du2 = (uvs[:, 2, 0] - uvs[:, 0, 0]).astype(np.float32)
        dv2 = (uvs[:, 2, 1] - uvs[:, 0, 1]).astype(np.float32)
        det = -du1 * dv2 + dv1 * du2
        coef = (1.0 / np.where(det == 0.0, 1.0, det)).astype(np.float32)
        t_v = (e1f * (-dv2)[:, None] + e2f * dv1[:, None]) * coef[:, None]
        b_v = (e1f * (-du2)[:, None] + e2f * du1[:, None]) * coef[:, None]
        t_v = t_v / np.maximum(np.linalg.norm(t_v, axis=1, keepdims=True),
                               1e-20)
        b_v = b_v / np.maximum(np.linalg.norm(b_v, axis=1, keepdims=True),
                               1e-20)
        tri_tbn = np.concatenate([t_v, b_v], axis=1).astype(np.float32)

        if self._sph_center:
            sc = np.stack(self._sph_center, 0)
            sr = np.asarray(self._sph_radius, np.float32)
            smat = np.asarray(self._sph_mat, np.int32)
        else:
            sc = np.zeros((0, 3), np.float32)
            sr = np.zeros((0,), np.float32)
            smat = np.zeros((0,), np.int32)
        # sphere area: reference returns pi r^2 (Sphere.hpp:135-137, a bug);
        # default here is the true 4 pi r^2
        factor = np.pi if self.tutu_sphere_area else 4.0 * np.pi
        sarea = factor * sr * sr

        m = self._mat
        emission = np.stack(m['emission'], 0) if m['mtype'] else \
            np.zeros((0, 3), np.float32)
        is_light = emission.any(axis=1) if len(emission) else \
            np.zeros((0,), bool)

        # light list: every primitive whose material emits
        # (PPMGenerator::initializeLights, PPMGenerator.hpp:317-324)
        lk, li, la = [], [], []
        lverts, lnorms, lem = [], [], []
        for i in range(len(tmat)):
            if is_light[tmat[i]]:
                lk.append(TRIANGLE)
                li.append(i)
                la.append(tarea[i])
                lverts.append(verts[i])
                lnorms.append(normals[i])
                lem.append(emission[tmat[i]])
        for i in range(len(smat)):
            if is_light[smat[i]]:
                lk.append(SPHERE)
                li.append(i)
                la.append(sarea[i])
                lverts.append(np.zeros((3, 3), np.float32))
                lnorms.append(np.zeros((3, 3), np.float32))
                lem.append(emission[smat[i]])
        lverts = np.stack(lverts, 0) if lverts else \
            np.zeros((0, 3, 3), np.float32)
        lnorms = np.stack(lnorms, 0) if lnorms else \
            np.zeros((0, 3, 3), np.float32)
        lem = np.stack(lem, 0) if lem else np.zeros((0, 3), np.float32)

        t = lambda a, dtype: _tensor(np.asarray(a, dtype), device)

        def v3(a):
            a = np.asarray(a, np.float32).reshape(-1, 3)
            return Vec3(t(a[:, 0], np.float32), t(a[:, 1], np.float32),
                        t(a[:, 2], np.float32))

        stack3 = lambda key: np.stack(m[key], 0) if m['mtype'] else \
            np.zeros((0, 3))
        materials = MaterialTable(
            mtype=t(m['mtype'], np.int32),
            diffuse=v3(stack3('diffuse')),
            specular=v3(stack3('specular')),
            emission=v3(emission),
            alpha=t(m['alpha'], np.float32),
            eta=t(m['eta'], np.float32),
            roughness=t(m['roughness'], np.float32),
            metallic=t(m['metallic'], np.float32),
            diffuse_map=t(m['dmap'], np.int32),
            normal_map=t(m['nmap'], np.int32),
            roughness_map=t(m['rmap'], np.int32),
            metallic_map=t(m['mmap'], np.int32),
        )
        f32 = lambda a: t(a, np.float32)
        return SceneData(
            tv0=v3(verts[:, 0]), tv1=v3(verts[:, 1]), tv2=v3(verts[:, 2]),
            tn0=v3(normals[:, 0]), tn1=v3(normals[:, 1]),
            tn2=v3(normals[:, 2]),
            tuv0u=f32(uvs[:, 0, 0]), tuv0v=f32(uvs[:, 0, 1]),
            tuv1u=f32(uvs[:, 1, 0]), tuv1v=f32(uvs[:, 1, 1]),
            tuv2u=f32(uvs[:, 2, 0]), tuv2v=f32(uvs[:, 2, 1]),
            tmat=t(tmat, np.int32), tarea=f32(tarea),
            tri_shade=f32(tri_shade), tri_tbn=f32(tri_tbn),
            scenter=v3(sc), sradius=f32(sr), smat=t(smat, np.int32),
            sarea=f32(sarea),
            materials=materials,
            light_kind=t(lk, np.int32), light_idx=t(li, np.int32),
            light_area=f32(la),
            light_v0=v3(lverts[:, 0]), light_v1=v3(lverts[:, 1]),
            light_v2=v3(lverts[:, 2]),
            light_n0=v3(lnorms[:, 0]), light_n1=v3(lnorms[:, 1]),
            light_n2=v3(lnorms[:, 2]),
            light_emission=v3(lem),
            diffuse_maps=_stack_textures(self.textures['diffuse'], device),
            normal_maps=_stack_textures(self.textures['normal'], device),
            roughness_maps=_stack_textures(self.textures['roughness'], device),
            metallic_maps=_stack_textures(self.textures['metallic'], device),
            bkgcolor=Vec3(f32(self.bkgcolor[0]), f32(self.bkgcolor[1]),
                          f32(self.bkgcolor[2])),
            eta=f32(self.eta),
            **{k: f32(v) for k, v in _woop_arrays(verts).items()},
            has_textures=any(len(v) > 0 for v in self.textures.values()),
            mtype_set=tuple(sorted(set(int(x) for x in m['mtype']))),
        )


def _woop_arrays(verts: np.ndarray):
    """Per-triangle inverse-basis rows, factorised in float64 on the host
    (SceneBuilder._woop_arrays of the JAX package, same numpy calls, so the
    rows are bit-equal). For triangle (v0, e1, e2) with n = e1 x e2, the
    inverse of the column basis [e1 e2 n] has rows r1, r2, r3 = n/|n|^2; a
    point p maps to barycentric (u, v, w) = rows . (p - v0)."""
    t = verts.shape[0]
    if t == 0:
        return dict(woop_w=np.zeros((3, 0), np.float32),
                    woop_c=np.zeros((0,), np.float32),
                    woop_nlen=np.zeros((0,), np.float32))
    v0 = verts[:, 0].astype(np.float64)
    e1 = verts[:, 1].astype(np.float64) - v0
    e2 = verts[:, 2].astype(np.float64) - v0
    n = np.cross(e1, e2)
    basis = np.stack([e1, e2, n], axis=2)        # [T,3,3] columns
    det = np.linalg.det(basis)
    ok = np.abs(det) > 1e-30
    safe = basis.copy()
    safe[~ok] = np.eye(3)
    rows = np.linalg.inv(safe)                   # [T,3,3] rows r1,r2,r3
    rows[~ok] = 0.0
    c = np.einsum('tij,tj->ti', rows, v0)        # [T,3]: c[i,j] = row_j.v0
    # layout: w[k, 3*i + j] = rows[i, j, k]
    w = rows.transpose(2, 0, 1).reshape(3, 3 * t)
    return dict(woop_w=w.astype(np.float32),
                woop_c=c.reshape(-1).astype(np.float32),
                woop_nlen=np.linalg.norm(n, axis=1).astype(np.float32))


_NESTED = {"materials": MaterialTable, "diffuse_maps": TextureAtlas,
           "normal_maps": TextureAtlas, "roughness_maps": TextureAtlas,
           "metallic_maps": TextureAtlas}
_STATIC = ("has_textures", "mtype_set")


def _fields_from_flat(cls, arrays, prefix, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in _STATIC:
            continue
        key = prefix + f.name
        if f.name in _NESTED:
            sub = _NESTED[f.name]
            kw[f.name] = sub(**_fields_from_flat(sub, arrays, key + ".",
                                                 device))
        elif key in arrays:
            kw[f.name] = _tensor(arrays[key], device)
        else:
            kw[f.name] = Vec3(*(_tensor(arrays[f"{key}.{c}"], device)
                                for c in "xyz"))
    return kw


def scene_from_numpy(arrays: dict, device="cpu") -> SceneData:
    """SceneData from the JAX ``SceneData`` fields flattened to numpy.

    Keys are field names, dotted for nested fields (``tv0.x``,
    ``materials.diffuse.x``, ``diffuse_maps.rgb``, ``bkgcolor.x``), the
    static fields ``has_textures`` and ``mtype_set`` included. dtypes are
    kept as given (float32 and int32 in a JAX scene)."""
    if any(k.split(".")[0] in ("bvh", "clusters") for k in arrays):
        raise NotImplementedError(f"BVH/cluster tables: {_CLUSTER_SCENES}")
    _check_dense(np.asarray(arrays["tmat"]).shape[0])
    return SceneData(
        **_fields_from_flat(SceneData, arrays, "", device),
        has_textures=bool(np.asarray(arrays["has_textures"])),
        mtype_set=tuple(int(x) for x in np.ravel(arrays["mtype_set"])))
