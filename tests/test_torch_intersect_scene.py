"""The port's ``ops/intersect.py::intersect_scene`` (``shade_hit`` of
``intersect_core``) against the JAX package's on the same rays, on the
CPU, every HitRecord field (``torch_port_util.check_hit_records``):

- simple_box (12 triangles and two spheres, a dense scene): its 24x20
  camera rays (a frame with no pixel centre on the quads' diagonals) and
  256 random rays from inside the box, on the JAX package's CPU route
  (XLA Moller-Trumbore) against the port's Woop form (K1's arithmetic)
  and its Moller-Trumbore form (K3's);
- a small sphere_showcase (nu = nv = 46, 4,236 triangles with cluster
  tables): its 24x20 camera rays and 256 random rays, the JAX XLA BVH
  against the port's cluster route (K5's arithmetic).

t and idx are compared where t is unique (t bit-equal in the
Moller-Trumbore form); knife edges (a hit within 1e-5
of its triangle's edge in barycentrics) are left out, where Woop and
Moller-Trumbore, or two roundings of one test, may split a ray.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (REF_SIZE, check_hit_records, flatten,
                             port_scene)
from tuturenderer_tpu.ops import intersect as JI
from tuturenderer_tpu.utils.vec import Vec3 as JVec3
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.utils.vec import Vec3


def jvec(a):
    return JVec3(*[jnp.asarray(a[:, i]) for i in range(3)])


def tvec(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  for i in range(3)])


def rays(jcam, lo, hi, seed, n_random=256):
    """The camera's primary rays (JAX's ``primary_ray``) and ``n_random``
    rays from random points in the box [lo, hi]^3, as float32 numpy."""
    from tuturenderer_tpu.camera import primary_ray
    pix = jnp.arange(jcam.width * jcam.height, dtype=jnp.int32)
    o, d, _ = primary_ray(jcam, pix % jcam.width, pix // jcam.width)
    r = np.random.RandomState(seed)
    ro = lo + (hi - lo) * r.rand(n_random, 3)
    rd = r.randn(n_random, 3)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = np.concatenate([np.stack([np.asarray(c) for c in o], 1), ro])
    d = np.concatenate([np.stack([np.asarray(c) for c in d], 1), rd])
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def box():
    from tuturenderer_tpu.scene.presets import simple_box
    jscene, jcam = simple_box(*REF_SIZE)
    scene, _ = port_scene("box")
    o, d = rays(jcam, -0.99, 0.99, seed=5)
    return scene, o, d, JI.intersect_scene(jscene, jvec(o), jvec(d))


@pytest.fixture(scope="module")
def showcase():
    from torch_port_util import SHOWCASE_NU, SHOWCASE_NV
    from tuturenderer_tpu.models.scenes import sphere_showcase
    jscene, jcam = sphere_showcase(*REF_SIZE, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    scene, _ = port_scene("showcase")
    o, d = rays(jcam, -1.5, 1.5, seed=6)
    return scene, o, d, JI.intersect_scene(jscene, jvec(o), jvec(d))


@pytest.mark.parametrize("form", ["woop", "mt"])
def test_simple_box_matches_jax(box, form, monkeypatch):
    scene, o, d, jrec = box
    assert scene.clusters is None and scene.n_spheres == 2
    monkeypatch.setattr(TI, "DENSE_KERNEL", form)
    for k in K.LAUNCHES:
        monkeypatch.setitem(K.LAUNCHES, k, 0)
    rec = TI.intersect_scene(scene, tvec(o), tvec(d))
    # a CPU tensor takes the plain versions, which count no launch
    assert not any(K.LAUNCHES.values())
    # the MT form computes the JAX CPU route's t, bit for bit
    n = check_hit_records(scene, o, d, rec, jrec,
                          t_tol=(0.0, 0.0) if form == "mt" else (1e-5, 1e-6))
    assert n["held"] >= 0.97 * n["hits"] and n["hits"] >= 0.5 * len(o), n
    # both sphere materials and the triangles' are hit
    kinds = rec.kind.numpy()[rec.hit.numpy()]
    assert (kinds == 1).sum() > 10 and (kinds == 0).sum() > 100


def test_simple_box_is_shade_hit_of_intersect_core(box):
    scene, o, d, _ = box
    rec = TI.intersect_scene(scene, tvec(o), tvec(d))
    want = TI.shade_hit(scene, tvec(o), tvec(d),
                        TI.intersect_core(scene, tvec(o), tvec(d)))
    for f, got in rec._asdict().items():
        a = torch.stack(list(got)) if isinstance(got, Vec3) else got
        b = getattr(want, f)
        b = torch.stack(list(b)) if isinstance(b, Vec3) else b
        assert torch.equal(a, b), f


def test_showcase_matches_jax(showcase):
    scene, o, d, jrec = showcase
    assert scene.clusters is not None and scene.n_tris == 4236
    rec = TI.intersect_scene(scene, tvec(o), tvec(d))
    n = check_hit_records(scene, o, d, rec, jrec)
    assert n["held"] >= 0.97 * n["hits"] and n["hits"] >= 0.5 * len(o), n


def test_scene_tables_match_jax(showcase):
    """The port scene of the showcase (its own builder) holds the JAX
    scene's triangle and shading tables, so the fields above compare one
    scene."""
    from torch_port_util import SHOWCASE_NU, SHOWCASE_NV
    from tuturenderer_tpu.models.scenes import sphere_showcase
    jscene, _ = sphere_showcase(*REF_SIZE, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    scene = showcase[0]
    want, got = flatten(jscene), flatten(scene)
    for key in ("tv0.x", "tv1.y", "tv2.z", "tri_shade", "tmat", "tarea"):
        assert np.array_equal(got[key], want[key]), key
