"""The PyTorch port's differentiable light tracer (``grad.render_light_diff``)
against the JAX package's.

- against the stored JAX computation (``lt-diffuse`` of GRAD_CASES:
  tests/test_grad.py's diffuse_box at a 24x20 camera, 8 spp,
  lt_max_depth 3, seed 7): the image and the gradient of its mean for every
  MaterialParams leaf, both fed the same scene tables, the port in its
  Moller-Trumbore dense form as the JAX package's CPU route computes;
  tolerance: the image at the render bar (>= 99 % of pixels within rtol
  1e-4 / atol 1e-5, the mean within 0.5 %), each leaf within 1e-2 of its
  largest stored magnitude;
- the direct pane's max-combine: ``pane_max`` / ``pane_shares`` route the
  gradient of a chain of scatter-maxes, ties included (with the zero film
  too), as JAX's ``.at[].max`` differentiates it, equal within 1e-6;
- tests/test_grad.py's finite-difference check on the port, at its scene,
  options and tolerances (emission rtol 2e-2, diffuse rtol 5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (GRAD_CASES, GRAD_LEAVES, GRAD_REFS, GRAD_SEED,
                             assert_at_bar, check_stored, flatten, grad_case,
                             jax_grad_case)
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import scene_from_numpy

NAME = "lt-diffuse"


@pytest.fixture(autouse=True)
def port_mt(monkeypatch):
    monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")


@pytest.fixture(scope="module")
def jax_case():
    return jax_grad_case(NAME)


def _sub(arrays: dict, prefix: str):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def image_and_grads(fn, scene, cam, opts, seed):
    leaves = [a.detach().clone().requires_grad_(True)
              for a in G.get_params(scene).leaves()]
    img = fn(G.MaterialParams.from_leaves(leaves), scene, cam, opts, seed)
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    return img.detach().numpy(), [
        np.zeros(a.shape, np.float32) if g is None else g.numpy()
        for a, g in zip(leaves, grads)]


def check_against_jax(fn, name, want):
    scene = scene_from_numpy(_sub(want, "scene."), device="cpu")
    cam = camera_from_numpy(_sub(want, "camera."), device="cpu")
    img, grads = image_and_grads(fn, scene, cam,
                                 RenderOptions(**GRAD_CASES[name][1]),
                                 GRAD_SEED)
    assert_at_bar(img, want["image"])
    nonzero = 0
    for key, g in zip(GRAD_LEAVES, grads):
        w = want[f"grad.{key}"]
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * scale,
                                   err_msg=key)
        nonzero += int((w != 0).sum())
    assert nonzero >= 4


def test_stored_light_gradient_reference_is_the_jax_computation(jax_case):
    check_stored(GRAD_REFS[NAME], jax_case, grad_case(NAME), rtol=1e-6)


def test_image_and_gradients_match_jax(jax_case):
    check_against_jax(G.render_light_diff, NAME, jax_case)


def test_direct_pane_gradient_routes_ties_as_jax():
    """Four samples of scatter-max into five pixels over a zero film: a
    pixel raised then overtaken, two updates tied at the max in one
    sample, a max reached again by a later sample, a pixel whose max is
    the zero film's 0 with updates tied at 0, and lanes that land in the
    spare slot."""
    p, s_n = 5, 4
    idx = np.array([[0, 0, 1, 2, 3, -1],
                    [0, 1, 1, 2, 4, 3],
                    [1, 2, 4, 4, 0, -1],
                    [2, 3, 4, 0, 1, 1]], np.int32)
    base = np.array([[1.0, 2.0, 3.0, 0.0, 5.0, 9.0],
                     [2.0, 3.0, 3.0, 0.0, 4.0, 5.0],
                     [3.0, 0.0, 4.0, 4.0, 2.0, 7.0],
                     [0.0, 5.0, 4.0, 2.0, 1.0, 3.0]], np.float32)
    upd = np.stack([base, base * 2.0, np.where(base > 2, 0.0, base)], -1)
    upd = upd.astype(np.float32)                       # [S, n, 3]
    gd = np.random.RandomState(0).rand(p, 3).astype(np.float32)

    def pane(u):
        d = jnp.zeros((p, 3))
        for s in range(s_n):
            vidx = jnp.where(idx[s] >= 0, idx[s], p)
            d = d.at[vidx].max(u[s], mode="drop")
        return jnp.sum(d * gd)

    want = np.asarray(jax.grad(pane)(jnp.asarray(upd)))

    slots = torch.from_numpy(np.where(idx >= 0, idx, p)).long()
    vals = torch.from_numpy(upd)
    direct = torch.zeros((p + 1, 3))
    first = torch.full((p + 1, 3), -1, dtype=torch.int64)
    for s in range(s_n):
        direct, first = G.pane_max(direct, first, slots[s], vals[s], s)
    np.testing.assert_array_equal(direct[:p].numpy(),
                                  np.asarray(_jax_pane(upd, idx, p)))
    g_direct = torch.cat([torch.from_numpy(gd), torch.zeros((1, 3))])
    after = torch.ones_like(direct)
    got = [None] * s_n
    for s in reversed(range(s_n)):
        got[s], after = G.pane_shares(g_direct, after, direct, first,
                                      slots[s], vals[s], s)
    got = torch.stack(got).numpy()
    assert (want != 0).sum() >= 8
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _jax_pane(upd, idx, p):
    d = jnp.zeros((p, 3))
    for s in range(len(idx)):
        d = d.at[jnp.where(idx[s] >= 0, idx[s], p)].max(upd[s], mode="drop")
    return d


def test_light_tracing_gradients_match_fd():
    """tests/test_grad.py's check, on the port."""
    from test_grad import diffuse_box
    j_scene, j_cam = diffuse_box()
    scene = scene_from_numpy(flatten(j_scene), device="cpu")
    cam = camera_from_numpy(flatten(j_cam), device="cpu")
    opts = RenderOptions(spp=8, lt_max_depth=3)
    _, grads = image_and_grads(G.render_light_diff, scene, cam, opts, 5)
    flat = G.get_params(scene).leaves()

    def fd(leaf, idx, eps):
        def loss(sign):
            fl = [a.clone() for a in flat]
            fl[leaf][idx] += sign * eps
            with torch.no_grad():
                return float(G.render_light_diff(
                    G.MaterialParams.from_leaves(fl), scene, cam, opts,
                    5).double().mean())
        return (loss(1.0) - loss(-1.0)) / (2 * eps)

    assert grads[3][2] != 0.0
    np.testing.assert_allclose(grads[3][2], fd(3, 2, 1e-1), rtol=2e-2)
    assert grads[0][0] != 0.0
    np.testing.assert_allclose(grads[0][0], fd(0, 0, 1e-2), rtol=5e-2)
