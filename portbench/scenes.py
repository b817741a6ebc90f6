"""Scene inputs, made by the benchmark from a configuration file.

A configuration's ``scene`` lists materials by name and shapes that use
them: ``quad`` (four corners, two triangles p0-p1-p2 and p0-p2-p3),
``sphere``, ``plane`` (a parallelogram centre +- u_axis +- v_axis) and
``uv_sphere`` (a lat-long mesh with smooth vertex normals). ``scene_arrays``
turns it into plain numpy arrays, which the benchmark hands both to the
program (``build_program_scene``, through the program's public scene
builder) and to the plain reference (``reference.RefScene``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MATERIAL_TYPES = {"LAMBERTIAN": 0, "PERFECT_REFLECTIVE": 1,
                  "PERFECT_REFRACTIVE": 2, "MICROFACET_R": 3,
                  "MICROFACET_T": 4, "UNLIT": 5}
# a material's fields when the configuration leaves them out
MATERIAL_DEFAULTS = dict(diffuse=(0.9, 0.9, 0.9), specular=(1.0, 1.0, 1.0),
                         emission=(0.0, 0.0, 0.0), alpha=1.0, eta=1.0,
                         roughness=1.0, metallic=0.0)


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def quad(p0, p1, p2, p3) -> np.ndarray:
    return np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32)


def plane(center, u_axis, v_axis) -> np.ndarray:
    """Two triangles of the parallelogram centre +- u_axis +- v_axis."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u_axis, np.float32)
    v = np.asarray(v_axis, np.float32)
    s = np.linspace(-1.0, 1.0, 2)
    pts = c[None, None] + s[:, None, None] * u[None, None] \
        + s[None, :, None] * v[None, None]
    q00, q10, q01, q11 = pts[0, 0], pts[1, 0], pts[0, 1], pts[1, 1]
    return np.stack([np.stack([q00, q10, q11]),
                     np.stack([q00, q11, q01])]).astype(np.float32)


def uv_sphere(center, radius: float, nu: int, nv: int):
    """Lat-long sphere of 2 * nu * nv triangles wound outward, with unit
    vertex normals: (verts [n, 3, 3], normals [n, 3, 3])."""
    center = np.asarray(center, np.float32)
    u = np.linspace(0.0, 2.0 * np.pi, nu + 1)
    v = np.linspace(1e-4, np.pi - 1e-4, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    n = np.stack([np.sin(vv) * np.cos(uu), np.sin(vv) * np.sin(uu),
                  np.cos(vv)], -1)
    p = center[None, None] + radius * n

    def tris(a):
        a00, a10, a01, a11 = a[:-1, :-1], a[1:, :-1], a[:-1, 1:], a[1:, 1:]
        return np.concatenate([
            np.stack([a00, a11, a10], 2).reshape(-1, 3, 3),
            np.stack([a00, a01, a11], 2).reshape(-1, 3, 3)], 0) \
            .astype(np.float32)
    return tris(p), tris(n)


def scene_arrays(cfg: dict) -> dict:
    """The configuration's scene as numpy arrays:
    ``materials`` (a list of full field dicts, ``mtype`` an int),
    ``tris`` (a list of (verts, normals or None, material id)),
    ``spheres`` (a list of (centre, radius, material id)), ``bkgcolor``,
    ``eta``."""
    sc = cfg["scene"]
    names, materials = {}, []
    for name, fields in sc["materials"]:
        m = dict(MATERIAL_DEFAULTS, **{k: v for k, v in fields.items()
                                       if k != "type"})
        m["mtype"] = MATERIAL_TYPES[fields["type"]]
        names[name] = len(materials)
        materials.append(m)
    tris, spheres = [], []
    for shape in sc["shapes"]:
        mat = names[shape["material"]]
        if "quad" in shape:
            tris.append((quad(*shape["quad"]), None, mat))
        elif "plane" in shape:
            p = shape["plane"]
            tris.append((plane(p["center"], p["u_axis"], p["v_axis"]), None,
                         mat))
        elif "uv_sphere" in shape:
            p = shape["uv_sphere"]
            verts, normals = uv_sphere(p["center"], p["radius"], p["nu"],
                                       p["nv"])
            tris.append((verts, normals, mat))
        elif "sphere" in shape:
            p = shape["sphere"]
            spheres.append((np.asarray(p["center"], np.float32),
                            float(p["radius"]), mat))
        else:
            raise ValueError(f"unknown shape {sorted(shape)}")
    return dict(materials=materials, tris=tris, spheres=spheres,
                bkgcolor=np.asarray(sc.get("bkgcolor", (0, 0, 0)),
                                    np.float32),
                eta=float(sc.get("eta", 1.0)))


def n_triangles(arrays: dict) -> int:
    return sum(v.shape[0] for v, _, _ in arrays["tris"])


def build_program_scene(arrays: dict, device):
    """The program's scene from the arrays, through its public builder."""
    from tuturenderer_tpu_torch.scene.data import SceneBuilder
    b = SceneBuilder(bkgcolor=tuple(arrays["bkgcolor"].tolist()),
                     eta=arrays["eta"])
    ids = [b.add_material(m["mtype"], diffuse=m["diffuse"],
                          specular=m["specular"], emission=m["emission"],
                          alpha=m["alpha"], eta=m["eta"],
                          roughness=m["roughness"], metallic=m["metallic"])
           for m in arrays["materials"]]
    if ids != list(range(len(ids))):
        raise ValueError("two materials of the configuration are equal")
    for verts, normals, mat in arrays["tris"]:
        b.add_triangles(verts, normals, None, mat)
    for center, radius, mat in arrays["spheres"]:
        b.add_sphere(center, radius, mat)
    return b.build(device=device)


def program_camera(cam_cfg: dict, width: int, height: int, device):
    from tuturenderer_tpu_torch.camera import make_camera
    return make_camera(width, height, cam_cfg["hfov"], eye=cam_cfg["eye"],
                       viewdir=cam_cfg["viewdir"], updir=cam_cfg["updir"],
                       device=device)
