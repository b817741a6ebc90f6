"""The port's ``utils/vec.py`` against ``tuturenderer_tpu.utils.vec``: the
six cases of tests/test_vec.py, run on both packages, plus
``from_stacked``, ``select_scalar``, ``Vec3.abs``, ``Vec3.astype`` and
``Vec3.shape``. Inputs are seeded numpy arrays fed to both. Each test keeps
test_vec.py's own assertions on the port's result and holds that result to
the JAX function's: bit-equal where both packages evaluate the same
float32 expression in the same order (the algebra, reflect, the structural
helpers), rtol 1e-6 where a square root, a reciprocal square root or a
clamp may round differently (normalize, refract, local_to_world; a
direction's components within 1e-6 of its length).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuturenderer_tpu.utils import vec as JV
from tuturenderer_tpu_torch.utils import vec as TV


def rand(n, seed):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def both(a: np.ndarray):
    """(port Vec3, JAX Vec3) of the same [N, 3] array, by from_stacked."""
    return TV.from_stacked(torch.from_numpy(a)), \
        JV.from_stacked(jnp.asarray(a))


def cols(v) -> np.ndarray:
    return np.stack([np.asarray(c) for c in v], axis=-1)


def same(got, want, rtol=0.0):
    """A port result (Vec3 or tensor) against the JAX one: bit-equal, or
    within ``rtol`` of each value, a Vec3's components within ``rtol`` of
    the vector's length (a component near 0 of a unit vector carries the
    rounding of the whole vector)."""
    vector = isinstance(got, tuple)
    if vector:
        got, want = cols(got), cols(want)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not rtol:
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(want)
    if vector:
        scale = np.maximum(scale, np.linalg.norm(want, axis=-1,
                                                 keepdims=True))
    err = np.abs(got - want)
    assert (err <= rtol * scale).all(), (err / scale).max()


def test_basic_algebra():
    (a, ja), (b, jb) = both(rand(16, 1)), both(rand(16, 2))
    s = (a + b).stack().numpy()
    np.testing.assert_allclose(s, a.stack().numpy() + b.stack().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(a.dot(b).numpy(),
                               (a.stack().numpy() * b.stack().numpy()).sum(-1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        a.cross(b).stack().numpy(),
        np.cross(a.stack().numpy(), b.stack().numpy()), rtol=1e-4, atol=1e-5)
    for op in (lambda p, q: p + q, lambda p, q: p - q, lambda p, q: p * q,
               lambda p, q: p / q, lambda p, q: 2.0 - p * 0.5 + q / 3.0,
               lambda p, q: -p, lambda p, q: 1.0 / q, lambda p, q: p.cross(q),
               lambda p, q: JV.lerp(p, q, 0.3) if isinstance(p, JV.Vec3)
               else TV.lerp(p, q, 0.3)):
        same(op(a, b), op(ja, jb))
    same(a.dot(b), ja.dot(jb))
    same(a.norm2(), ja.norm2())
    same(a.max_component(), ja.max_component())


def test_normalize():
    a, ja = both(rand(16, 3))
    n = a.normalized()
    np.testing.assert_allclose(n.norm().numpy(), 1.0, rtol=1e-5)
    same(n, ja.normalized(), rtol=1e-6)
    same(a.normalized(1e-20), ja.normalized(1e-20), rtol=1e-6)
    same(a.norm(), ja.norm())


def test_reflect_is_mirror():
    n = TV.vec3(0.0, 0.0, 1.0)
    i = TV.vec3(1.0, 0.0, 1.0).normalized()
    r = TV.reflect(i, n)
    np.testing.assert_allclose(
        r.stack().numpy(), TV.vec3(-1.0, 0.0, 1.0).normalized().stack().numpy(),
        atol=1e-6)
    same(r, JV.reflect(JV.vec3(1.0, 0.0, 1.0).normalized(),
                       JV.vec3(0.0, 0.0, 1.0)))
    # and on seeded unit vectors
    (i, ji), (n, jn) = both(rand(16, 4)), both(rand(16, 5))
    same(TV.reflect(i, n), JV.reflect(ji, jn))


def test_refract_snell():
    n = TV.vec3(0.0, 0.0, 1.0)
    wo = TV.vec3(0.3, 0.0, 1.0).normalized()   # points away from surface
    d, tir = TV.refract(wo, n, 1.0, 1.5)
    assert not bool(tir)
    # Snell: sin_t = sin_i / 1.5
    sin_i = float(np.sqrt(1 - wo.dot(n).numpy() ** 2))
    sin_t = float(torch.sqrt(d.x ** 2 + d.y ** 2))
    np.testing.assert_allclose(sin_t, sin_i / 1.5, rtol=1e-5)
    assert float(d.z) < 0  # transmitted into the surface
    jd, jtir = JV.refract(JV.vec3(0.3, 0.0, 1.0).normalized(),
                          JV.vec3(0.0, 0.0, 1.0), 1.0, 1.5)
    same(d, jd, rtol=1e-6)
    same(tir, jtir)


def test_refract_tir():
    n = TV.vec3(0.0, 0.0, 1.0)
    wo = TV.vec3(5.0, 0.0, 1.0).normalized()
    d, tir = TV.refract(wo, n, 1.5, 1.0)   # dense -> sparse at grazing angle
    assert bool(tir)
    np.testing.assert_allclose(d.stack().numpy(), 0.0, atol=1e-7)
    jd, jtir = JV.refract(JV.vec3(5.0, 0.0, 1.0).normalized(),
                          JV.vec3(0.0, 0.0, 1.0), 1.5, 1.0)
    same(d, jd)
    same(tir, jtir)


@pytest.mark.parametrize("eta_i,eta_t", [(1.0, 1.5), (1.5, 1.0)])
def test_refract_matches_jax(eta_i, eta_t):
    """Seeded unit directions and normals, both sides of the surface; a
    third of them totally reflected going dense to sparse."""
    (i, ji), (n, jn) = both(rand(64, 6)), both(rand(64, 7))
    i, ji, n, jn = (v.normalized() for v in (i, ji, n, jn))
    d, tir = TV.refract(i, n, eta_i, eta_t)
    jd, jtir = JV.refract(ji, jn, eta_i, eta_t)
    same(tir, jtir)
    if eta_i > eta_t:
        assert 0 < tir.float().mean() < 1
    same(d, jd, rtol=1e-6)


def test_local_to_world_preserves_z():
    n = TV.vec3(0.3, -0.5, 0.8).normalized()
    w = TV.local_to_world(n, TV.vec3(0.0, 0.0, 1.0))
    np.testing.assert_allclose(w.stack().numpy(), n.stack().numpy(),
                               atol=1e-5)
    # orthogonal local x maps to something orthogonal to n
    w2 = TV.local_to_world(n, TV.vec3(1.0, 0.0, 0.0))
    np.testing.assert_allclose(float(w2.dot(n)), 0.0, atol=1e-5)
    jn = JV.vec3(0.3, -0.5, 0.8).normalized()
    same(w, JV.local_to_world(jn, JV.vec3(0.0, 0.0, 1.0)), rtol=1e-6)
    same(w2, JV.local_to_world(jn, JV.vec3(1.0, 0.0, 0.0)), rtol=1e-6)
    # seeded normals (|n.x| > 0.9 takes the other helper axis) and
    # directions
    a = rand(64, 8)
    a[:8] = [1, 0.01, 0.02]
    (n, jn), (loc, jloc) = both(a), both(rand(64, 9))
    n, jn = n.normalized(), jn.normalized()
    same(TV.local_to_world(n, loc), JV.local_to_world(jn, jloc), rtol=1e-6)
    for p, q in zip(TV.orthonormal_basis(n), JV.orthonormal_basis(jn)):
        same(p, q, rtol=1e-6)


def test_from_stacked_and_stack():
    a = rand(12, 10).reshape(3, 4, 3)
    v, jv = both(a)
    same(v, jv)
    assert v.x.shape == (3, 4)
    np.testing.assert_array_equal(v.stack().numpy(), a)
    np.testing.assert_array_equal(v.stack(dim=0).numpy(),
                                  np.asarray(jv.stack(axis=0)))


def test_select_scalar():
    r = np.random.RandomState(11)
    mask = r.rand(32) > 0.5
    a, b = r.randn(32).astype(np.float32), r.randn(32).astype(np.float32)
    got = TV.select_scalar(torch.from_numpy(mask), torch.from_numpy(a),
                           torch.from_numpy(b))
    same(got, JV.select_scalar(jnp.asarray(mask), jnp.asarray(a),
                               jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), np.where(mask, a, b))
    # a tensor against a Python scalar, and two scalars
    same(TV.select_scalar(torch.from_numpy(mask), torch.from_numpy(a), 0.5),
         JV.select_scalar(jnp.asarray(mask), jnp.asarray(a), 0.5))
    same(TV.select_scalar(torch.from_numpy(mask), 1.0, -1.0),
         JV.select_scalar(jnp.asarray(mask), 1.0, -1.0))


def test_abs():
    v, jv = both(rand(32, 12))
    got = v.abs()
    same(got, jv.abs())
    assert (got.stack() >= 0).all()
    same(TV.vec3(-0.0, -2.0, 3.0).abs(), JV.vec3(-0.0, -2.0, 3.0).abs())


@pytest.mark.parametrize("dtype", ["float16", "int32", "bool"])
def test_astype(dtype):
    """The port takes a torch dtype where JAX takes a numpy one."""
    v, jv = both(rand(32, 13) * 50.0)
    got = v.astype(getattr(torch, dtype))
    assert all(c.dtype == getattr(torch, dtype) for c in got)
    same(got, jv.astype(getattr(np, dtype)))


def test_shape():
    v, jv = both(rand(12, 14).reshape(4, 3, 3))
    assert v.shape == jv.shape == (4, 3)
    assert isinstance(v.shape, tuple)
    assert TV.vec3(1.0).shape == JV.vec3(1.0).shape == ()
