"""Shared helpers for the tests that hold the PyTorch port
(``tuturenderer_tpu_torch``) against the JAX package.

- ``flatten`` turns a SceneData or Camera of either package into a dict of
  numpy arrays keyed by field name (dotted for nested fields), the form
  ``scene_from_numpy`` / ``camera_from_numpy`` take;
- ``jax_dense_pallas_interpret`` makes the JAX package take its dense
  Pallas kernels (the Woop kernels the port's CUDA kernels replace) in
  interpret mode on the CPU, within the block only;
- ``REF_*`` say how ``tests/data/torch_simple_box_jax_ref.npy`` is made;
- ``MESH_CASES`` name the renders the mesh-scale slice is held to, and
  ``MESH_REFS`` where each is stored under ``tests/data/``
  (``make_torch_mesh_refs.py``: the image and ``mesh_case``, how it was
  rendered, in one ``.npz``); ``chip_smoke.py`` renders each case as its
  file says and holds the card's render against it;
- ``translucent_showcase`` builds sphere_showcase's geometry with the
  sphere's material at alpha 0.5 with either package's builder (the JAX
  package has no such preset);
- ``GRAD_CASES`` name the differentiable renders the port's gradients are
  held to (the path tracer's ``render_diff``, the light tracer's and
  BDPT's), ``GRAD_REFS`` where each is stored (``make_torch_grad_refs.py``:
  the scene, camera, image, gradient leaves and ``grad_case`` in one
  ``.npz``), and ``jax_grad_case`` computes one with the JAX package;
- ``INTEGRATOR_CASES`` name the light-tracing, naive path-tracing,
  compaction and BDPT renders held to stored JAX renders, ``INTEGRATOR_REFS``
  where each is stored (``make_torch_integrator_refs.py``: the image,
  for a compacted render the overflow count, and ``integrator_case``, how
  it was rendered, in one ``.npz``), and
  ``jax_integrator_render`` renders one with the JAX package;
  ``check_stored`` holds a stored file to a fresh JAX computation and the
  case it names, and ``check_compacted_render`` the port's compacted
  render to a JAX render;
- ``golden_config`` copies a config of ``golden/`` into a directory with
  its texture paths pointed at this checkout's ``golden/tex/`` (the files
  name them by an absolute path, valid only where the repository was
  when they were written) and, optionally, another ``imsize``;
- ``bvh_walk`` walks the port's BVH (``Clusters.bvh_*``) one ray at a time
  in float32 numpy, as ``csrc/bvh_walk.cu`` walks it in each of its three
  modes, so the CPU tests check the tree where the kernel cannot run;
- importing it sets one intra-op thread per process (see below);
- ``special_verts`` and ``special_rays`` make triangles and rays that reach
  the dense kernels' edge cases (in-plane rays, det = +-0, inf and NaN
  values, subnormal products, exact t ties), for the CPU tests against
  the JAX package and the card's tests against the plain versions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import os

import numpy as np
import torch

# The suite runs its files in several worker processes at once (xdist);
# an OpenMP pool as wide as the machine in each of them oversubscribes the
# cores, and its spinning barriers then slow the plain tensor code of the
# port's tests five-fold and more. One intra-op thread per process; every
# worker imports this module when it collects the port's test files.
torch.set_num_threads(1)

REF_PATH = os.path.join(os.path.dirname(__file__), "data",
                        "torch_simple_box_jax_ref.npy")
REF_SIZE = (24, 20)     # not a power of two: no pixel centre on a knife edge
REF_SPP = 4
REF_SEED = 3


def flatten(obj, key: str = "") -> dict:
    """Dataclass/Vec3 tree -> {dotted field name: numpy array}; None
    fields (no BVH/clusters) are left out."""
    if obj is None:
        return {}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):      # Vec3
        return {f"{key}.{c}": np.asarray(getattr(obj, c)) for c in obj._fields}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(flatten(getattr(obj, f.name),
                               f"{key}.{f.name}" if key else f.name))
        return out
    return {key: np.asarray(obj)}


@contextlib.contextmanager
def jax_dense_pallas_interpret():
    """Route the JAX package's dense intersection through its Pallas Woop
    kernels in interpret mode, and clear JAX's caches on entry and exit so
    no traced function crosses the boundary."""
    import jax

    import tuturenderer_tpu.ops.intersect as JI
    import tuturenderer_tpu.ops.pallas.intersect as JP
    saved = (JI.DENSE_IMPL, JP.pallas_tri_intersect, JP.pallas_tri_occluded)
    jax.clear_caches()
    JI.DENSE_IMPL = "pallas"
    JP.pallas_tri_intersect = functools.partial(saved[1], interpret=True)
    JP.pallas_tri_occluded = functools.partial(saved[2], interpret=True)
    try:
        yield
    finally:
        JI.DENSE_IMPL, JP.pallas_tri_intersect, JP.pallas_tri_occluded = saved
        jax.clear_caches()


def jax_reference_render() -> np.ndarray:
    """The JAX render the stored reference image holds."""
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import simple_box
    scene, cam = simple_box(*REF_SIZE)
    with jax_dense_pallas_interpret():
        return np.asarray(render(scene, cam, RenderOptions(spp=REF_SPP),
                                 seed=REF_SEED))


# the mesh-scale slice at test size: sphere_showcase(24, 20, nu=46, nv=46)
# has 4,236 triangles, so it carries cluster tables
SHOWCASE_NU = SHOWCASE_NV = 46
TRANSLUCENT_ALPHA = 0.5

# name -> (scene, RenderOptions fields); "box" scenes are simple_box, whose
# JAX render takes the dense Pallas kernels in interpret mode
MESH_CASES = {
    "showcase-mis": ("showcase", {}),
    "showcase-nee": ("showcase", {"mis": False}),
    "translucent-alpha": ("translucent", {"alpha_shadows": True}),
    "box-nee": ("box", {"mis": False}),
    "box-alpha": ("box", {"alpha_shadows": True}),
}
MESH_REFS = {name: os.path.join(os.path.dirname(__file__), "data",
                                f"torch_{name.replace('-', '_')}_jax_ref.npz")
             for name in MESH_CASES}
# a scene kind of the cases -> (the preset that builds it, its keywords);
# chip_smoke.py builds the scene a stored case names from these
SCENES = {"box": ("simple_box", {}),
          "showcase": ("sphere_showcase",
                       {"nu": SHOWCASE_NU, "nv": SHOWCASE_NV}),
          "translucent": ("translucent_showcase",
                          {"nu": SHOWCASE_NU, "nv": SHOWCASE_NV})}


def case_json(**case) -> np.ndarray:
    """How a stored reference was made, as the JSON text its ``.npz``
    stores under ``case`` (chip_smoke.py reads it from there)."""
    return np.asarray(json.dumps(case, sort_keys=True))


def mesh_case(name: str) -> np.ndarray:
    """How a MESH_CASES entry is rendered: the path tracer, the preset and
    its keywords, REF_SIZE, the RenderOptions fields and REF_SEED."""
    kind, fields = MESH_CASES[name]
    scene, kw = SCENES[kind]
    return case_json(integrator="path", scene=scene, scene_kw=kw,
                     size=list(REF_SIZE),
                     options={"spp": REF_SPP, **fields}, seed=REF_SEED)


def check_stored(path: str, out: dict, case: np.ndarray, rtol: float = 0):
    """The stored ``.npz`` at ``path`` holds exactly ``out`` (within
    ``rtol``) and ``case``."""
    want = {**out, "case": case}
    stored = np.load(path)
    assert sorted(stored.files) == sorted(want)
    assert str(stored["case"]) == str(case)
    for key in out:
        np.testing.assert_allclose(stored[key], want[key], rtol=rtol, atol=0,
                                   err_msg=key)


def translucent_showcase(pkg: str, width: int, height: int,
                         nu: int = SHOWCASE_NU, nv: int = SHOWCASE_NV,
                         **device):
    """sphere_showcase with the sphere's material at alpha 0.5, built with
    the ``pkg`` package ("tuturenderer_tpu" or "tuturenderer_tpu_torch";
    ``device`` goes to the latter's build and camera)."""
    data = importlib.import_module(pkg + ".scene.data")
    meshes = importlib.import_module(pkg + ".models.meshes")
    camera = importlib.import_module(pkg + ".camera")
    b = data.SceneBuilder(bkgcolor=(0.05, 0.05, 0.08))
    sphere_mat = b.add_material(data.MICROFACET_R, diffuse=(0.8, 0.3, 0.2),
                                roughness=0.3, metallic=0.2,
                                alpha=TRANSLUCENT_ALPHA)
    verts, normals = meshes.uv_sphere(radius=1.0, nu=nu, nv=nv)
    b.add_triangles(verts, normals, None, sphere_mat)
    ground = b.add_material(data.LAMBERTIAN, diffuse=(0.7, 0.7, 0.7))
    b.add_triangles(meshes.plane((0, -1, 0), (0, 0, 6), (6, 0, 0)), None,
                    None, ground)
    light = b.add_material(data.LAMBERTIAN, emission=(12.0, 11.0, 10.0))
    b.add_triangles(meshes.plane((0, 3, 0), (1, 0, 0), (0, 0, 1)), None,
                    None, light)
    scene = b.build(**device)
    cam = camera.make_camera(width, height, 45, eye=(0, 0.6, -3.5),
                             viewdir=(0, -0.12, 1), updir=(0, 1, 0),
                             **device)
    return scene, cam


def jax_mesh_scene(name: str):
    """The JAX (scene, camera) of a MESH_CASES entry at REF_SIZE."""
    from tuturenderer_tpu.models.scenes import sphere_showcase
    from tuturenderer_tpu.scene.presets import simple_box
    kind = MESH_CASES[name][0]
    if kind == "showcase":
        return sphere_showcase(*REF_SIZE, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    if kind == "translucent":
        return translucent_showcase("tuturenderer_tpu", *REF_SIZE)
    return simple_box(*REF_SIZE)


@contextlib.contextmanager
def jax_route(name: str):
    """The JAX package's own CPU route for a MESH_CASES scene: its XLA BVH
    and dense transmittance for the mesh scenes, the dense Pallas kernels
    in interpret mode for simple_box."""
    if MESH_CASES[name][0] == "box":
        with jax_dense_pallas_interpret():
            yield
    else:
        yield


def jax_mesh_render(name: str, scene=None, cam=None) -> np.ndarray:
    """The JAX render of a MESH_CASES entry at REF_SIZE x REF_SPP, seed
    REF_SEED, as MESH_REFS stores it."""
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    if scene is None:
        scene, cam = jax_mesh_scene(name)
    opts = RenderOptions(spp=REF_SPP, **MESH_CASES[name][1])
    with jax_route(name):
        return np.asarray(render(scene, cam, opts, seed=REF_SEED))


# the differentiable renders: name -> (tests/test_grad.py scene, RenderOptions
# fields, the renderer of grad.py); all at a 24x20 camera (test_grad.py's
# 32x32 puts pixel centres on the quads' diagonals, where the two packages'
# roundings split a ray between two triangles, or neither), seed 7, loss =
# the image mean; the light tracer's and BDPT's options are test_grad.py's
GRAD_CASES = {
    "diffuse-mis": ("diffuse_box", {"spp": 2, "max_depth": 3},
                    "render_diff"),
    "ggx-nee": ("ggx_box", {"spp": 4, "max_depth": 0, "mis": False},
                "render_diff"),
    "lt-diffuse": ("diffuse_box", {"spp": 8, "lt_max_depth": 3},
                   "render_light_diff"),
    "bdpt-diffuse": ("diffuse_box", {"spp": 4, "bdpt_max_path_length": 4},
                     "render_bdpt_diff"),
}
GRAD_SEED = 7
GRAD_REFS = {name: os.path.join(os.path.dirname(__file__), "data",
                                f"torch_grad_{name.replace('-', '_')}"
                                "_jax_ref.npz")
             for name in GRAD_CASES}
# the flat leaf order of MaterialParams in both packages
GRAD_LEAVES = ("diffuse.x", "diffuse.y", "diffuse.z", "emission.x",
               "emission.y", "emission.z", "roughness", "metallic")


def jax_grad_scene(name: str):
    """The JAX (scene, camera) of a GRAD_CASES entry."""
    import test_grad
    from tuturenderer_tpu.camera import make_camera
    scene, _ = getattr(test_grad, GRAD_CASES[name][0])()
    cam = make_camera(*REF_SIZE, 60, eye=(0, 0, -3.2), viewdir=(0, 0, 1),
                      updir=(0, 1, 0))
    return scene, cam


def grad_case(name: str) -> np.ndarray:
    """How a GRAD_CASES entry is computed (its ``.npz`` holds the scene and
    camera tables too): the renderer of grad.py, the scene, the camera
    size, the RenderOptions fields and GRAD_SEED."""
    scene, fields, renderer = GRAD_CASES[name]
    return case_json(renderer=renderer, scene=scene, size=list(REF_SIZE),
                     options=fields, seed=GRAD_SEED)


def jax_grad_case(name: str) -> dict:
    """{"scene.*", "camera.*", "image", "grad.<leaf>"} numpy arrays of a
    GRAD_CASES entry: the JAX image of its renderer and jax.grad of its
    mean, one traced graph (the JAX package's CPU route: its XLA MT
    intersection)."""
    import jax
    import jax.numpy as jnp
    from tuturenderer_tpu import grad
    from tuturenderer_tpu.options import RenderOptions
    scene, cam = jax_grad_scene(name)
    _, fields, renderer = GRAD_CASES[name]
    opts = RenderOptions(differentiable=True, **fields)
    run = getattr(grad, renderer)

    def loss(p):
        img = run(p, scene, cam, opts, seed=GRAD_SEED)
        return jnp.mean(img), img

    (_, img), grads = jax.value_and_grad(loss, has_aux=True)(
        grad.get_params(scene))
    out = {f"scene.{k}": v for k, v in flatten(scene).items()}
    out.update({f"camera.{k}": v for k, v in flatten(cam).items()})
    out["image"] = np.asarray(img)
    for key, leaf in zip(GRAD_LEAVES, jax.tree.flatten(grads)[0]):
        out[f"grad.{key}"] = np.asarray(leaf)
    return out


# the light tracer, the naive path tracer, compaction and BDPT: name ->
# (integrator, scene, RenderOptions fields, (width, height)); REF_SPP spp
# unless the fields say otherwise, seed REF_SEED. The showcase walks take
# lt_max_depth 4: its light is out of view, so a 2-vertex naive walk
# renders black. BDPT renders mostly at a bdpt_max_path_length below the
# default 7: the JAX side compiles its 27 strategies for ~50 s on the
# CPU (the showcase, on its CPU route) and its 14 dense kernel calls in
# interpret mode for ~180 s. simple_box takes 3 (6 interpret-mode calls,
# ~50 s), the showcase 5 (14 strategies, ~30 s), once with both BDPT quirks
# off (an open scene, where the t=1 gate drops the splats of lanes whose
# camera ray missed); one showcase case takes the default 7, the length
# every BDPT path on the card runs at (its fresh JAX render has a test file
# of its own).
# The compacted renders use an 80x64 frame, 5,120 lanes, so a 0.25 width
# shrinks the wavefront (1,280 rounds up to 2,048 lanes); a
# square frame puts simple_box's pixel centres on its quads' diagonals,
# where the two packages can split a camera ray differently, and one lane
# more or less alive changes every survivor's overflow weight
COMPACT_SIZE = (80, 64)
INTEGRATOR_CASES = {
    "lt-box": ("light", "box", {}, REF_SIZE),
    "naive-box": ("naivept", "box", {}, REF_SIZE),
    "lt-showcase": ("light", "showcase", {"lt_max_depth": 4}, REF_SIZE),
    "naive-showcase": ("naivept", "showcase", {"lt_max_depth": 4}, REF_SIZE),
    "compact-mis": ("path", "box", {"compaction": (1.0, 0.5)}, COMPACT_SIZE),
    "compact-overflow": ("path", "box", {"compaction": (1.0, 0.25)},
                         COMPACT_SIZE),
    "bdpt-box": ("bdpt", "box", {"bdpt_max_path_length": 3}, REF_SIZE),
    "bdpt-showcase": ("bdpt", "showcase", {"bdpt_max_path_length": 5},
                      REF_SIZE),
    "bdpt-showcase-quirks-off": ("bdpt", "showcase",
                                 {"bdpt_max_path_length": 5,
                                  "tutu_bdpt_weight_kill": False,
                                  "tutu_bdpt_t1_gate": False}, REF_SIZE),
    "bdpt-showcase-7": ("bdpt", "showcase", {"bdpt_max_path_length": 7},
                        REF_SIZE),
}
INTEGRATOR_REFS = {name: os.path.join(os.path.dirname(__file__), "data",
                                      f"torch_{name.replace('-', '_')}"
                                      "_jax_ref.npz")
                   for name in INTEGRATOR_CASES}


def integrator_fields(name: str) -> dict:
    """The RenderOptions fields of an INTEGRATOR_CASES entry, spp
    included."""
    return {"spp": REF_SPP, **INTEGRATOR_CASES[name][2]}


def jax_integrator_render(name: str) -> dict:
    """{"image"} (and {"compaction_overflow"} for a compacted render) of an
    INTEGRATOR_CASES entry, rendered by the JAX package: simple_box through
    its dense Pallas kernels in interpret mode, the showcase through its CPU
    route (its XLA BVH)."""
    import importlib as il

    from tuturenderer_tpu.models.scenes import sphere_showcase
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import simple_box
    integrator, kind, _, size = INTEGRATOR_CASES[name]
    module = {"path": "path", "light": "light", "naivept": "naive",
              "bdpt": "bdpt"}
    run = il.import_module(
        f"tuturenderer_tpu.integrators.{module[integrator]}").render
    opts = RenderOptions(**integrator_fields(name))
    if kind == "showcase":
        scene, cam = sphere_showcase(*size, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
        ctx = contextlib.nullcontext()
    else:
        scene, cam = simple_box(*size)
        ctx = jax_dense_pallas_interpret()
    with ctx:
        if integrator == "path":
            img, st = run(scene, cam, opts, REF_SEED, stats=True)
            return {"image": np.asarray(img), "compaction_overflow":
                    np.asarray(st["compaction_overflow"])}
        return {"image": np.asarray(run(scene, cam, opts, REF_SEED))}


def compact_port_box():
    """The port's (scene, camera) of simple_box at COMPACT_SIZE, from the
    tables JAX builds, on the CPU."""
    from tuturenderer_tpu.scene.presets import simple_box
    from tuturenderer_tpu_torch.camera import camera_from_numpy
    from tuturenderer_tpu_torch.scene.data import scene_from_numpy
    scene, cam = simple_box(*COMPACT_SIZE)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


def integrator_case(name: str) -> np.ndarray:
    """How an INTEGRATOR_CASES entry is rendered, as the JSON text its
    ``.npz`` stores under ``case``: the integrator, the preset and its
    keywords, the image size, the RenderOptions fields and the seed."""
    integrator, kind, _, size = INTEGRATOR_CASES[name]
    scene, kw = SCENES[kind]
    return case_json(integrator=integrator, scene=scene, scene_kw=kw,
                     size=list(size), options=integrator_fields(name),
                     seed=REF_SEED)


def check_stored_reference(name: str, out: dict):
    """The stored ``.npz`` of an INTEGRATOR_CASES entry holds ``out`` and
    the entry's ``integrator_case``."""
    check_stored(INTEGRATOR_REFS[name], out, integrator_case(name))


def port_scene(kind: str, size=REF_SIZE):
    """The port's (scene, camera) of a case's scene kind on the CPU:
    simple_box from the tables JAX builds, the showcase from the port's
    own builder (with cluster tables)."""
    if kind == "showcase":
        from tuturenderer_tpu_torch.models.scenes import sphere_showcase
        return sphere_showcase(*size, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                               device="cpu")
    from tuturenderer_tpu.scene.presets import simple_box
    from tuturenderer_tpu_torch.camera import camera_from_numpy
    from tuturenderer_tpu_torch.scene.data import scene_from_numpy
    scene, cam = simple_box(*size)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


def assert_at_bar(got: np.ndarray, want: np.ndarray):
    """A port render against a JAX render: >= 99 % of pixels within rtol
    1e-4 / atol 1e-5 on all three channels, the image mean within 0.5 %."""
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * abs(want.mean())


def check_compacted_render(name: str, want: dict, scene, cam) -> int:
    """The port's render of a compacted INTEGRATOR_CASES entry against the
    JAX package's ``want``: the overflow count equal, the image at the
    path tracer's bar. Returns the count."""
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.options import RenderOptions
    img, st = render(scene, cam, RenderOptions(**integrator_fields(name)),
                     REF_SEED, stats=True)
    over = int(st["compaction_overflow"])
    assert over == int(want["compaction_overflow"])
    got, ref = img.numpy(), want["image"]
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - ref.mean()) <= 0.005 * ref.mean()
    return over


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden")


def golden_config(name: str, directory: str, imsize=None) -> str:
    """Copy ``golden/<name>`` into ``directory`` with each texture path
    pointed at the file of that name in this checkout's ``golden/tex/``
    and, given ``imsize`` (width, height), that image size. Returns the
    copy's path."""
    from tuturenderer_tpu_torch.scene.config import relocate_config
    return relocate_config(os.path.join(GOLDEN_DIR, name),
                           os.path.join(directory, name),
                           os.path.join(GOLDEN_DIR, "tex"), imsize)


def _slab(box, o, inv, bound):
    """(entered, tmin) of a padded box (lo(3), hi(3)) in float32, the
    kernel's slab test."""
    t0 = (box[:3] - o) * inv
    t1 = (box[3:] - o) * inv
    tmin = np.minimum(t0, t1).max()
    tmax = np.maximum(t0, t1).min()
    return bool(tmin <= tmax and tmax >= 0.0 and tmin < bound), tmin


def _woop_test(row, o, d):
    """(t, u, v, accepted) of one 12-float Woop row in float32, in the
    kernels' order of operations."""
    f = np.float32
    r1, c1, r2, c2, r3, c3 = row[0:3], row[3], row[4:7], row[7], row[8:11], \
        row[11]
    w_o = o[0] * r3[0] + o[1] * r3[1] + o[2] * r3[2] - c3
    w_d = d[0] * r3[0] + d[1] * r3[1] + d[2] * r3[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = f(1.0) / w_d
        t = -w_o * inv
        u = (o[0] * r1[0] + o[1] * r1[1] + o[2] * r1[2] - c1) + \
            t * (d[0] * r1[0] + d[1] * r1[1] + d[2] * r1[2])
        v = (o[0] * r2[0] + o[1] * r2[1] + o[2] * r2[2] - c2) + \
            t * (d[0] * r2[0] + d[1] * r2[1] + d[2] * r2[2])
        ok = abs(w_d) >= f(1e-4) and t > 0 and u > 0 and v > 0 and \
            f(1.0) - u - v > 0
    return t, u, v, bool(ok)


def bvh_walk(nodes, rows, o, d, dist=None, leaf_bits: int = 4,
             transmit=None):
    """Walk the BVH (``nodes [K, 16]`` f32, ``rows [R, 12]`` f32, numpy)
    for each ray (``o``, ``d`` [N, 3] f32): nearer child first and pruned
    by the best t for the nearest hit; with ``dist`` [N], in link order and
    pruned by dist, the any hit within dist with the endpoint guard, or,
    given ``transmit = (virt [R] i32, woop [C, 8, 128] f32)``, the product
    of (1 - alpha) over the crossings with t < dist in walk order, alpha
    read through each row's virtual id from woop's slot 13, the walk ending
    when the product is 0. Returns (t, row, bu, bv, tested) per ray for the
    nearest hit (row -1 on a miss; tested: the set of rows the walk
    tested), (blocked, tested) for the any hit, or (trans, tested)."""
    f = np.float32
    boxes = nodes[:, :12]
    links = nodes.view(np.int32)[:, 12:14]
    # child boxes as lo(3), hi(3)
    kid = [boxes[:, [0, 2, 8, 1, 3, 9]], boxes[:, [4, 6, 10, 5, 7, 11]]]
    if transmit is not None:
        virt, woop = transmit
        flat = woop.reshape(len(woop), -1)
        alpha = flat[virt // 64, virt % 64 * 14 + 13]
    out = []
    for i in range(len(o)):
        oi, di = o[i].astype(f), d[i].astype(f)
        inv = np.array([f(1.0) / (c if c != 0 else f(1e-30)) for c in di], f)
        bound = f(3.4e38) if dist is None else f(dist[i])
        t_best, best, bu, bv, stop = f(3.4e38), -1, f(0), f(0), False
        trans = f(1.0)
        tested, stack, node = set(), [], 0
        while node is not None and not stop:
            if node >= 0:
                hits = [_slab(kid[c][node], oi, inv, bound) for c in (0, 1)]
                a, b = (int(x) for x in links[node])
                if hits[0][0] and hits[1][0]:
                    near_a = dist is not None or hits[0][1] <= hits[1][1]
                    stack.append(b if near_a else a)
                    node = a if near_a else b
                elif hits[0][0] or hits[1][0]:
                    node = a if hits[0][0] else b
                else:
                    node = stack.pop() if stack else None
                continue
            code = -1 - node
            first, count = code >> leaf_bits, code & ((1 << leaf_bits) - 1)
            for r in range(first, first + count):
                tested.add(r)
                t, u, v, ok = _woop_test(rows[r], oi, di)
                if not ok:
                    continue
                if dist is None:
                    if t < t_best:
                        t_best, best, bu, bv = t, r, u, v
                elif transmit is None:
                    if t < bound and abs(t - bound) >= f(1e-4):
                        stop = True
                        break
                elif t < bound:
                    trans = f(trans * (f(1.0) - alpha[r]))
                    if trans == 0.0:
                        stop = True
                        break
            if dist is None:
                bound = t_best
            node = stack.pop() if stack else None
        if dist is None:
            out.append((t_best, best, bu, bv, tested))
        else:
            out.append((stop if transmit is None else trans, tested))
    return out


# triangles: a unit right triangle in z = 0 (at 0 and again at 3, for an
# exact t tie), a tilted one, a tiny one (e ~ 1e-19: |n| and det
# subnormal or 0), a huge one (det overflows to inf), and one whose
# in-plane ray d = (1, -0, -0) gives det = -0
SPECIAL_TRIS = [
    [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
    [[0, 0, 1], [1, 0, 2], [0, 1, 1.5]],
    [[0, 0, 0.5], [1e-19, 0, 0.5], [0, 1e-19, 0.5]],
    [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
    [[-3e19, -3e19, 2], [3e19, -3e19, 2], [0, 3e19, 2]],
    [[0, 0, 0], [1, 0, 0], [0.3, -1, 1]],
]


def special_verts() -> np.ndarray:
    """[16, 3, 3] float32: ``SPECIAL_TRIS`` and ten random triangles."""
    r = np.random.RandomState(11)
    centers = r.randn(10, 3)
    soup = centers[:, None, :] + 0.6 * r.randn(10, 3, 3)
    return np.concatenate([np.asarray(SPECIAL_TRIS), soup]).astype(np.float32)


def special_rays(verts):
    """[N, 3] origins and directions, float32, and the number of leading
    rays whose answers neither rounding nor subnormals decide: in-plane
    rays, inf and NaN values. The rays after them make subnormal
    products, graze edges and vertices, or are random."""
    rays = []
    # in each triangle's plane, along and against its edges
    for v0, v1, v2 in verts[:6].astype(np.float64):
        for e in (v1 - v0, v2 - v0, v2 - v1, (v1 - v0) + (v2 - v0)):
            for sgn in (1.0, -1.0):
                rays.append((v0 + 0.25 * (v1 - v0) - sgn * e, sgn * e))
    rays.append(((0.5, 0.0, 0.0), (1.0, -0.0, -0.0)))
    # inf and NaN components, in the origin and in the direction
    o_hit, d_hit = (0.2, 0.2, 1.0), (0.0, 0.0, -1.0)
    for k in range(3):
        for bad in (np.inf, -np.inf, np.nan):
            o = list(o_hit)
            o[k] = bad
            rays.append((o, d_hit))
            d = list(d_hit)
            d[k] = bad
            rays.append((o_hit, d))
    n_values = len(rays)
    # subnormal products: tiny directions and offsets
    for tiny in (1e-25, -1e-25, 1e-38, 1e-40, -1e-44):
        rays.append(((0.2, 0.2, 1.0), (tiny, tiny, -1.0)))
        rays.append(((0.2, 0.2, tiny), (0.0, 0.0, -1.0)))
        rays.append(((0.2, 0.2, 1.0), (tiny, tiny, tiny)))
        rays.append(((1e-20, 1e-20, 1.0), (tiny, tiny, -1.0)))
    # through the tiny and the huge triangle, and grazing the unit one's
    # edges and vertices (and along the tilted one's long edge)
    rays.append(((2e-20, 2e-20, 1.0), (0.0, 0.0, -1.0)))
    rays.append(((0.0, 0.0, 5.0), (0.0, 0.0, -1.0)))
    rays.append(((1e19, 0.0, 5.0), (0.0, 0.0, -1.0)))
    for p in ((0.5, 0.5, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
              (0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.3, 0.3, 0.0)):
        rays.append(((p[0], p[1], 1.0), (0.0, 0.0, -1.0)))
        rays.append(((p[0] + 0.1, p[1] - 0.1, -1.0), (-0.1, 0.1, 1.0)))
    o = np.asarray([np.asarray(a, np.float64) for a, _ in rays])
    d = np.asarray([np.asarray(b, np.float64) for _, b in rays])
    # and random rays aimed at the triangles
    r = np.random.RandomState(12)
    n = 192
    ro = r.randn(n, 3) * 3.0
    aim = verts[r.randint(0, len(verts), n)].mean(axis=1)
    aim[: n // 2] = verts[r.randint(6, len(verts), n // 2)].mean(axis=1)
    rd = aim + 0.4 * r.randn(n, 3) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    with np.errstate(all="ignore"):
        return (np.concatenate([o, ro]).astype(np.float32),
                np.concatenate([d, rd]).astype(np.float32), n_values)


# the shell: name -> what the JAX package computed; SHELL_REFS where each
# is stored (``make_torch_shell_refs.py``: the arrays and ``case``, how
# they were made, in one ``.npz``). "cli-ppm" is the JAX CLI's PPM of
# tests/test_cli.py's CONFIG; "checkpoint-*" the checkpoint JAX's
# render_progressive wrote after 2 of a stored render's REF_SPP samples
# (the simple_box path render of REF_PATH and INTEGRATOR_REFS' "lt-box"),
# whose resumption is held to that stored image; "grid" JAX's
# estimator_grid of CONFIG. simple_box renders take the dense Pallas kernels
# in interpret mode, as the stored renders they resume do.
CLI_ARGS = ["--spp", "2", "--max-depth", "2"]
SHELL_CASES = {
    "cli-ppm": {"argv": CLI_ARGS},
    "checkpoint-path": {"integrator": "path", "resumes": "simple_box_ref",
                        "spp_done": 2, "chunk_spp": 2},
    "checkpoint-light": {"integrator": "light", "resumes": "lt-box",
                         "spp_done": 2, "chunk_spp": 2},
    "grid": {"options": {"spp": 2, "max_depth": 2}, "seed": 0},
}
SHELL_REFS = {name: os.path.join(os.path.dirname(__file__), "data",
                                 f"torch_shell_{name.replace('-', '_')}"
                                 "_jax_ref.npz")
              for name in SHELL_CASES}


def shell_case(name: str) -> np.ndarray:
    """How a SHELL_CASES entry was made, as the JSON text its ``.npz``
    stores under ``case``; a checkpoint's names the render it resumes,
    its size, seed and RenderOptions fields."""
    case = dict(SHELL_CASES[name])
    if name.startswith("checkpoint"):
        case.update(size=list(REF_SIZE), seed=REF_SEED,
                    options={"spp": REF_SPP})
    return case_json(**case)


def resumed_image(name: str) -> np.ndarray:
    """The stored JAX render a checkpoint case resumes to."""
    resumes = SHELL_CASES[name]["resumes"]
    if resumes == "simple_box_ref":
        return np.load(REF_PATH)
    return np.load(INTEGRATOR_REFS[resumes])["image"]


def jax_shell_ref(name: str, directory: str) -> dict:
    """The arrays of a SHELL_CASES entry, computed by the JAX package on
    the CPU (files go under ``directory``)."""
    import dataclasses as dc

    from test_cli import CONFIG
    from tuturenderer_tpu.options import RenderOptions
    cfg = os.path.join(directory, "scene.txt")
    with open(cfg, "w") as f:
        f.write(CONFIG)
    case = SHELL_CASES[name]
    with jax_dense_pallas_interpret():
        if name == "cli-ppm":
            from tuturenderer_tpu.cli import main
            from tuturenderer_tpu.io.ppm import read_ppm
            out = os.path.join(directory, "cli.ppm")
            main([cfg, *case["argv"], "-o", out])
            return {"ppm": np.rint(read_ppm(out) * 255).astype(np.uint8)}
        if name == "grid":
            from tuturenderer_tpu.render import estimator_grid
            from tuturenderer_tpu.scene.config import parse_config
            pc = parse_config(cfg)
            return {"image": np.asarray(estimator_grid(
                pc.builder.build(), pc.camera(),
                RenderOptions(**case["options"]), seed=case["seed"]))}
        from tuturenderer_tpu.render import render_progressive
        from tuturenderer_tpu.scene.presets import simple_box
        scene, cam = simple_box(*REF_SIZE)
        ck = os.path.join(directory, "ck.npz")
        render_progressive(scene, cam, dc.replace(
            RenderOptions(spp=REF_SPP), spp=case["spp_done"]),
            case["integrator"], seed=REF_SEED, chunk_spp=case["chunk_spp"],
            checkpoint_path=ck, progress=False)
        return dict(np.load(ck))
