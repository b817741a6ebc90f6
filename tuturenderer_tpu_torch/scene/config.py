"""Scene-description (config.txt) parser.

The port of ``tuturenderer_tpu/scene/config.py``, host-side Python, token
for token. It implements the whitespace-token keyword grammar of the
reference's PPMGenerator (processKeyword, PPMGenerator.hpp:488-791; inline
geometry readObject, PPMGenerator.hpp:328-482): camera/viewport keywords,
material state machine (``mtlcolor`` updates color/alpha/eta but the
material TYPE persists until the next material keyword,
``MICROFACET_R/T``, ``PERFECT_REFLECTIVE/REFRACTIVE`` switch the current
type), texture bindings (``texture``/``bump``/``roughnessTexture``/
``metallicTexture`` with dedup-by-name), inline v/vn/vt/f/sphere geometry
with the four f-line variants, the ``integrator`` selector, and the legacy
parsed-and-discarded ``light``/``attlight``/``depthcueing``/``projection``
keywords.

Returns a ParsedConfig with the port's SceneBuilder, camera settings, and
the integrator choice: the equivalent of a fully initialized PPMGenerator.
``ParsedConfig.camera(device=...)`` builds the camera on the card unless
told otherwise, as ``SceneBuilder.build(device=...)`` does.

``relocate_config`` copies a config with its texture paths pointed at
another directory (a config names its textures by absolute paths, which
move with the files) and, optionally, another image size.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import numpy as np

from ..camera import Camera, make_camera
from ..io.ppm import read_ppm
from ..utils.device import DEFAULT_DEVICE
from .data import (LAMBERTIAN, MICROFACET_R, MICROFACET_T,
                   PERFECT_REFLECTIVE, PERFECT_REFRACTIVE, SceneBuilder)

INTEGRATORS = {"path": 0, "light": 1, "naivept": 2, "bdpt": 3}
TEXTURE_KEYS = ("texture", "bump", "roughnessTexture", "metallicTexture")

_FLAT = re.compile(r"^[0-9]+$")
_SMOOTH = re.compile(r"^[0-9]+//[0-9]+$")
_FLAT_T = re.compile(r"^[0-9]+/[0-9]+$")
_SMOOTH_T = re.compile(r"^[0-9]+/[0-9]+/[0-9]+$")


@dataclasses.dataclass
class ParsedConfig:
    builder: SceneBuilder
    width: int
    height: int
    hfov: float
    eye: tuple
    viewdir: tuple
    updir: tuple
    bkgcolor: tuple
    eta: float
    integrator: str
    parallel_projection: bool

    def camera(self, device=DEFAULT_DEVICE) -> Camera:
        return make_camera(self.width, self.height, self.hfov, self.eye,
                           self.viewdir, self.updir, self.parallel_projection,
                           device=device)


@dataclasses.dataclass
class _MtlState:
    mtype: int = LAMBERTIAN
    diffuse: tuple = (0.9, 0.9, 0.9)
    specular: tuple = (1.0, 1.0, 1.0)
    emission: tuple = (0.0, 0.0, 0.0)
    alpha: float = 1.0
    eta: float = 1.0
    roughness: float = 1.0
    metallic: float = 0.0


class ConfigParser:
    def __init__(self, path: str, texture_root: Optional[str] = None):
        self.path = path
        self.root = texture_root or os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            self.tok = f.read().split()
        self.i = 0
        self.b = SceneBuilder()
        self.mtl = _MtlState()
        self.mtl_id: Optional[int] = None
        self.texture_on = False
        self.tex_idx = -1
        self.bump_idx = -1
        self.rough_idx = -1
        self.metal_idx = -1
        self.vertices: List[List[float]] = []
        self.normals: List[List[float]] = []
        self.uvs: List[List[float]] = []
        # camera fields
        self.width = self.height = -1
        self.hfov = -1
        self.eye = self.viewdir = self.updir = self.bkg = None
        self.eta = 1.0
        self.integrator = None
        self.parallel = False

    # ------------------------------------------------------------------
    def _next(self) -> str:
        if self.i >= len(self.tok):
            raise ValueError("Insufficient or invalid data as input")
        t = self.tok[self.i]
        self.i += 1
        return t

    def _f(self) -> float:
        return float(self._next())

    def _i(self) -> int:
        return int(self._next())

    def _vec3(self):
        return (self._f(), self._f(), self._f())

    def _mtl_index(self) -> int:
        """Materialize the current material state (+ active texture
        bindings) as a material-table row. Texture-index consumption
        mirrors readObject (PPMGenerator.hpp:374-395): bump/rough/metal
        indices apply once then deactivate."""
        m = self.mtl
        dmap = self.tex_idx if self.texture_on else -1
        nmap = self.bump_idx if self.texture_on else -1
        rmap = self.rough_idx if self.texture_on else -1
        mmap = self.metal_idx if self.texture_on else -1
        if self.texture_on:
            self.bump_idx = -1
            self.rough_idx = -1
            self.metal_idx = -1
        return self.b.add_material(
            mtype=m.mtype, diffuse=m.diffuse, specular=m.specular,
            emission=m.emission, alpha=m.alpha, eta=m.eta,
            roughness=m.roughness, metallic=m.metallic,
            diffuse_map=dmap, normal_map=nmap, roughness_map=rmap,
            metallic_map=mmap)

    def _load_texture(self, category: str) -> int:
        name = self._next()
        p = name if os.path.isabs(name) else os.path.join(self.root, name)
        rgb = read_ppm(p)
        if category == "normal":
            # decode to tangent space [-1, 1] (PPMGenerator.hpp:711-721)
            rgb = rgb * 2.0 - 1.0
        return self.b.add_texture(category, name, rgb)

    # ------------------------------------------------------------------
    def _face_corner(self, tok: str):
        if _FLAT.match(tok):
            return int(tok) - 1, -1, -1
        if _SMOOTH.match(tok):
            v, n = tok.split("//")
            return int(v) - 1, -1, int(n) - 1
        if _SMOOTH_T.match(tok):
            v, t, n = tok.split("/")
            return int(v) - 1, int(t) - 1, int(n) - 1
        if _FLAT_T.match(tok):
            v, t = tok.split("/")
            return int(v) - 1, int(t) - 1, -1
        raise ValueError("f face information is not valid")

    def _read_face(self):
        corners = [self._face_corner(self._next()) for _ in range(3)]
        vs = np.asarray([self.vertices[c[0]] for c in corners], np.float32)
        if all(c[2] >= 0 for c in corners):
            ns = np.asarray([self.normals[c[2]] for c in corners], np.float32)
        else:
            e1 = vs[1] - vs[0]
            e2 = vs[2] - vs[0]
            fn = np.cross(e1, e2)
            nn = np.linalg.norm(fn)
            fn = fn / nn if nn > 0 else fn
            ns = np.repeat(fn[None], 3, 0)
        if all(c[1] >= 0 for c in corners):
            ts = np.asarray([self.uvs[c[1]] for c in corners], np.float32)
        else:
            ts = np.full((3, 2), -1.0, np.float32)
        self.b.add_triangles(vs[None], ns[None], ts[None], self._mtl_index())

    # ------------------------------------------------------------------
    def parse(self) -> ParsedConfig:
        while self.i < len(self.tok):
            key = self._next()
            if key == "imsize":
                self.width = self._i()
                self.height = self._i()
            elif key == "eye":
                self.eye = self._vec3()
            elif key == "viewdir":
                self.viewdir = self._vec3()
            elif key == "hfov":
                self.hfov = self._i()
            elif key == "updir":
                self.updir = self._vec3()
            elif key == "bkgcolor":
                self.bkg = self._vec3()
                self.eta = self._f()
            elif key == "projection":
                self.parallel = self._next() == "parallel"
            elif key == "light":
                for _ in range(7):
                    self._f()       # parsed-and-discarded (PPMGenerator.hpp:558-567)
            elif key == "attlight":
                for _ in range(10):
                    self._f()
            elif key == "mtlcolor":
                d = self._vec3()
                s = self._vec3()
                a = self._f()
                e = self._f()
                # the reference's mtlcolor sets ONLY diffuse/specular/
                # alpha/eta (PPMGenerator.hpp:583-609); the material TYPE
                # and roughness/metallic persist until the next material
                # keyword — a config can never return to LAMBERTIAN after
                # MICROFACET_*. Reproduced exactly (oracle-validated:
                # tex_128 golden). Emission (our grammar extension) is
                # scoped to the material block and resets here.
                self.mtl = dataclasses.replace(
                    self.mtl, diffuse=d, specular=s, alpha=a, eta=e,
                    emission=(0.0, 0.0, 0.0))
                self.texture_on = False
            elif key in ("MICROFACET_R", "MICROFACET_T"):
                d = self._vec3()
                a = self._f()
                e = self._f()
                r = self._f()
                m = self._f()
                self.mtl = dataclasses.replace(
                    self.mtl,
                    mtype=MICROFACET_R if key == "MICROFACET_R" else MICROFACET_T,
                    diffuse=d, alpha=a, eta=e, roughness=r, metallic=m)
            elif key == "emission":
                # extension: the reference grammar cannot express emissive
                # materials (emission is only set in its hard-coded mains,
                # e.g. main_cornellBox.cpp:33-34); this keyword fills that gap
                self.mtl = dataclasses.replace(self.mtl, emission=self._vec3())
            elif key == "PERFECT_REFLECTIVE":
                self.mtl = dataclasses.replace(self.mtl, mtype=PERFECT_REFLECTIVE)
            elif key == "PERFECT_REFRACTIVE":
                e = self._f()
                self.mtl = dataclasses.replace(self.mtl,
                                               mtype=PERFECT_REFRACTIVE, eta=e)
            elif key == "depthcueing":
                for _ in range(7):
                    self._f()       # parsed, unused legacy
            elif key == "texture":
                self.tex_idx = self._load_texture("diffuse")
                self.texture_on = True
            elif key == "bump":
                self.bump_idx = self._load_texture("normal")
                self.texture_on = True
            elif key == "roughnessTexture":
                self.rough_idx = self._load_texture("roughness")
                self.texture_on = True
            elif key == "metallicTexture":
                self.metal_idx = self._load_texture("metallic")
                self.texture_on = True
            elif key == "integrator":
                name = self._next()
                if name not in INTEGRATORS:
                    raise ValueError("unknown integrator")
                self.integrator = name
            elif key == "v":
                self.vertices.append([self._f(), self._f(), self._f()])
            elif key == "vn":
                n = np.asarray([self._f(), self._f(), self._f()])
                n = n / np.linalg.norm(n)
                self.normals.append(n.tolist())
            elif key == "vt":
                self.uvs.append([self._f(), self._f()])
            elif key == "f":
                self._read_face()
            elif key == "sphere":
                x, y, z, r = self._f(), self._f(), self._f(), self._f()
                self.b.add_sphere((x, y, z), r, self._mtl_index())
            else:
                raise ValueError(f"extraneous string in the input file: {key}")

        missing = (self.width == -1 or self.height == -1 or self.eye is None
                   or self.viewdir is None or self.hfov == -1
                   or self.updir is None or self.bkg is None
                   or self.integrator is None)
        if missing:
            raise ValueError("insufficient input data: unable to start")
        self.b.bkgcolor = np.asarray(self.bkg, np.float32)
        self.b.eta = self.eta
        return ParsedConfig(
            builder=self.b, width=self.width, height=self.height,
            hfov=self.hfov, eye=self.eye, viewdir=self.viewdir,
            updir=self.updir, bkgcolor=self.bkg, eta=self.eta,
            integrator=self.integrator, parallel_projection=self.parallel)


def parse_config(path: str) -> ParsedConfig:
    return ConfigParser(path).parse()


def relocate_config(src: str, dst: str, tex_dir: str,
                    imsize: Optional[tuple] = None) -> str:
    """Copy the config file ``src`` to ``dst`` with each texture path
    pointed at the file of that name in ``tex_dir`` and, given ``imsize``
    (width, height), that image size. Returns ``dst``."""
    with open(src) as f:
        lines = f.read().splitlines()
    for i, ln in enumerate(lines):
        key = ln.split()[:1]
        if key and key[0] in TEXTURE_KEYS:
            tex = os.path.join(tex_dir, os.path.basename(ln.split()[1]))
            lines[i] = f"{key[0]} {tex}"
        elif key == ["imsize"] and imsize is not None:
            lines[i] = f"imsize {imsize[0]} {imsize[1]}"
    with open(dst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dst
