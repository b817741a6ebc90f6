"""The port of tests/test_models.py: the procedural mesh generators, the
mesh-scale presets and the profiling counters, each held to the JAX
package on the same inputs.

- The mesh generators are numpy in both packages: their arrays are equal
  (``np.array_equal``), and test_models.py's own assertions hold on the
  port's.
- The presets' small renders (test_models.py's sizes) are held to stored
  JAX renders (``tests/data/torch_models_*_jax_ref.npz``, made by
  ``tests/data/make_torch_models_refs.py``) at the port's usual bar: >= 99 %
  of pixels within rtol 1e-4 / atol 1e-5, the mean within 0.5 %; in the
  port's Woop form (K1's arithmetic) and its Moller-Trumbore form (the JAX
  CPU route's). Each stored file is held to a fresh JAX render.
- The large preset's cluster tables are the JAX package's, array for
  array (the XLA BVH, ``scene.bvh``, is not ported).
- ``utils/profiling.py``: ``Profiler.phase``/``report``,
  ``rays_per_path`` and ``measure_render`` against the JAX module's.
"""
import io

import numpy as np
import pytest
import torch

import tuturenderer_tpu.models as JM
import tuturenderer_tpu_torch.models as TM
from torch_port_util import (MODEL_CASES, MODEL_REFS, MODEL_SEED,
                             assert_at_bar, check_stored, jax_model_render,
                             model_case, model_scene)


def test_quad_and_plane():
    q = TM.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    assert q.shape == (2, 3, 3)
    p = TM.plane((0, 0, 0), (1, 0, 0), (0, 1, 0), nu=4, nv=3)
    assert p.shape == (2 * 4 * 3, 3, 3)
    # total area of the subdivided parallelogram = |2u x 2v| = 4
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    np.testing.assert_allclose(area, 4.0, rtol=1e-5)
    jq = JM.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    jp = JM.plane((0, 0, 0), (1, 0, 0), (0, 1, 0), nu=4, nv=3)
    assert q.dtype == jq.dtype and np.array_equal(q, jq)
    assert p.dtype == jp.dtype and np.array_equal(p, jp)
    for args in (((0, -1, 0), (0, 0, 6), (6, 0, 0)),
                 ((0, 3, 0), (1.5, 0, 0), (0, 0, 1.5), 3, 5)):
        assert np.array_equal(TM.plane(*args), JM.plane(*args))


def test_uv_sphere_geometry():
    verts, normals = TM.uv_sphere(radius=2.0, nu=32, nv=32)
    assert verts.shape == (2 * 32 * 32, 3, 3)
    r = np.linalg.norm(verts.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(r, 2.0, atol=1e-3)
    # smooth normals point radially outward
    n = normals.reshape(-1, 3)
    v = verts.reshape(-1, 3) / r[:, None]
    assert (np.sum(n * v, axis=1) > 0.999).all()
    # surface area approaches 4 pi r^2
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    np.testing.assert_allclose(area, 4 * np.pi * 4.0, rtol=0.02)
    jverts, jnormals = JM.uv_sphere(radius=2.0, nu=32, nv=32)
    assert np.array_equal(verts, jverts) and np.array_equal(normals, jnormals)
    assert verts.dtype == jverts.dtype and normals.dtype == jnormals.dtype


def test_heightfield():
    v = TM.heightfield(nx=16, nz=16, size=2.0, amplitude=0.3, seed=1)
    assert v.shape == (2 * 16 * 16, 3, 3)
    assert np.abs(v[:, :, 1]).max() <= 0.3 + 1e-6
    assert np.abs(v[:, :, [0, 2]]).max() <= 1.0 + 1e-6
    jv = JM.heightfield(nx=16, nz=16, size=2.0, amplitude=0.3, seed=1)
    assert v.dtype == jv.dtype and np.array_equal(v, jv)
    assert np.array_equal(TM.heightfield(nx=12, nz=12, seed=0),
                          JM.heightfield(nx=12, nz=12, seed=0))


@pytest.mark.parametrize("form", ["woop", "mt"])
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_scene_presets_render(name, form, monkeypatch):
    """test_models.py's small terrain and showcase renders on the port,
    against the stored JAX renders."""
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.ops import intersect
    from tuturenderer_tpu_torch.options import RenderOptions
    monkeypatch.setattr(intersect, "DENSE_KERNEL", form)
    scene, cam = model_scene("tuturenderer_tpu_torch", name, device="cpu")
    assert scene.n_lights > 0 and scene.clusters is None
    img = render(scene, cam, RenderOptions(**MODEL_CASES[name][3]),
                 MODEL_SEED).numpy()
    width, height = MODEL_CASES[name][2]
    assert img.shape == (height, width, 3)
    assert np.isfinite(img).all() and img.max() > 0
    stored = np.load(MODEL_REFS[name])
    assert str(stored["case"]) == str(model_case(name))
    assert_at_bar(img, stored["image"])


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_stored_render_is_jax(name):
    """Each stored image is what the JAX package renders now."""
    check_stored(MODEL_REFS[name], {"image": jax_model_render(name)},
                 model_case(name))


def test_large_preset_builds_clusters():
    scene, _ = TM.sphere_showcase(width=8, height=8, nu=64, nv=64,
                                  device="cpu")                # 8k tris
    assert scene.clusters is not None
    c = scene.clusters
    assert int(c.tri_idx.max()) == scene.n_tris - 1
    # every triangle appears exactly once across clusters
    idx = c.tri_idx.numpy().ravel()
    idx = idx[idx >= 0]
    assert len(idx) == scene.n_tris and len(np.unique(idx)) == scene.n_tris
    # the tables JAX builds, array for array
    jscene, _ = JM.sphere_showcase(width=8, height=8, nu=64, nv=64)
    assert scene.n_tris == jscene.n_tris
    jc = jscene.clusters
    assert (c.n_clusters, c.cluster_size) == (jc.n_clusters, jc.cluster_size)
    for f in ("aabb", "woop", "tri_idx", "scene_lo", "scene_hi"):
        assert np.array_equal(getattr(c, f).numpy(),
                              np.asarray(getattr(jc, f)), equal_nan=True), f
    # and the BVH the cluster kernels walk holds every real row once
    assert np.array_equal(np.sort(c.bvh_virt.numpy()),
                          np.flatnonzero(c.tri_idx.numpy().ravel() >= 0))


def test_profiler_and_counters():
    from tuturenderer_tpu.utils import profiling as JP
    from tuturenderer_tpu_torch.utils.profiling import (Profiler,
                                                        measure_render,
                                                        rays_per_path)
    prof = Profiler()
    with prof.phase("a", sync=False):
        pass
    with prof.phase("a", sync=False):
        pass
    with prof.phase("b"):
        torch.zeros(8).sum()
    out = io.StringIO()
    totals = prof.report(file=out)
    assert "a" in totals and totals["a"] >= 0
    assert sorted(totals) == ["a", "b"] and len(prof.records) == 3
    assert totals["a"] == prof.records[0].seconds + prof.records[1].seconds
    assert out.getvalue().splitlines()[0].split()[0] == "a"
    off = Profiler(enabled=False)
    with off.phase("a"):
        pass
    assert off.records == [] and off.report(file=io.StringIO()) == {}
    assert rays_per_path(6) == 2.0 * 7 + 0.1
    fracs = [1.0, 0.8, 0.5, 0.25]
    for args, kw in (((6,), {}), ((3, fracs), {}),
                     ((3, fracs), {"epilogue": 0.25, "nee": False}),
                     ((0,), {"nee": False})):
        assert rays_per_path(*args, **kw) == JP.rays_per_path(*args, **kw)
    stats = measure_render(lambda: np.zeros(()), 10, 10, 4, 6)
    assert stats.paths == 400 and stats.rays_per_sec > 0
    assert stats.rays == 400 * rays_per_path(6)
    assert stats.paths_per_sec == stats.paths / stats.wall_s
    stats = measure_render(lambda: torch.zeros(()), 10, 10, 4, 3,
                           alive_fractions=fracs)
    jstats = JP.measure_render(lambda: np.zeros(()), 10, 10, 4, 3,
                               alive_fractions=fracs)
    assert (stats.paths, stats.rays) == (jstats.paths, jstats.rays)
    assert "M paths/s" in str(stats)
