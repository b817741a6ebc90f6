"""Compaction at mesh scale and on the differentiable path.

- sphere_showcase(24, 20, nu=46, nv=46), 4,236 triangles with cluster
  tables, under the NEE-only estimator, and its translucent variant (the
  sphere at alpha 0.5) under ``alpha_shadows`` and the MIS estimator: 16
  spp in one wavefront (``samples_per_launch``, 7,680 lanes, so a width
  fraction shrinks the wavefront), a schedule that overflows; each package
  builds its own scene, the JAX side takes its CPU route (its XLA BVH and
  dense transmittance), the port its cluster kernels' plain versions. The
  overflow count is equal and the image is held at the path tracer's bar
  (>= 99 % of pixels within rtol 1e-4 / atol 1e-5, the mean within
  0.5 %);
- ``render_diff`` runs the compacted bounce loop too: its forward image
  equals ``render``'s (exactly: the same code), and the gradients of its
  mean are finite, at least one of them nonzero.
"""
import numpy as np
import pytest
import torch

from torch_port_util import (REF_SEED, REF_SIZE, SHOWCASE_NU, SHOWCASE_NV,
                             translucent_showcase)
from tuturenderer_tpu.integrators.path import render as j_render
from tuturenderer_tpu.models.scenes import sphere_showcase as j_showcase
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.integrators.path import render
from tuturenderer_tpu_torch.models.scenes import sphere_showcase
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.presets import simple_box

W, H = REF_SIZE
CASES = {
    "showcase-nee": dict(mis=False, compaction=(1.0, 0.5)),
    "translucent-alpha": dict(alpha_shadows=True, compaction=(1.0, 0.25)),
}
BATCH = dict(spp=16, samples_per_launch=16, max_depth=3)


def _scene(pkg: str, name: str):
    if name == "translucent-alpha":
        return translucent_showcase(
            pkg, W, H, **({"device": "cpu"} if pkg != "tuturenderer_tpu"
                          else {}))
    if pkg == "tuturenderer_tpu":
        return j_showcase(W, H, nu=SHOWCASE_NU, nv=SHOWCASE_NV)
    return sphere_showcase(W, H, nu=SHOWCASE_NU, nv=SHOWCASE_NV,
                           device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_compaction_matches_jax(name):
    fields = dict(BATCH, **CASES[name])
    j_scene, j_cam = _scene("tuturenderer_tpu", name)
    want, j_st = j_render(j_scene, j_cam, JOptions(**fields), REF_SEED,
                          stats=True)
    scene, cam = _scene("tuturenderer_tpu_torch", name)
    assert scene.clusters is not None
    img, st = render(scene, cam, RenderOptions(**fields), REF_SEED,
                     stats=True)
    over = int(st["compaction_overflow"])
    assert over > 0 and over == int(j_st["compaction_overflow"])
    got, want = img.numpy(), np.asarray(want)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * want.mean()


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee"])
def test_render_diff_runs_the_compacted_loop(mis):
    scene, cam = simple_box(64, 48, device="cpu")
    opts = RenderOptions(spp=2, max_depth=3, mis=mis,
                         compaction=(1.0, 0.5, 0.25))
    want, st = render(scene, cam, opts, REF_SEED, stats=True)
    assert int(st["compaction_overflow"]) > 0
    params = G.get_params(scene)
    leaves = [a.clone().requires_grad_(True) for a in params.leaves()]
    img = G.render_diff(G.MaterialParams.from_leaves(leaves), scene, cam,
                        opts, REF_SEED)
    torch.testing.assert_close(img.detach(), want, rtol=0, atol=0)
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    got = [g for g in grads if g is not None]
    assert got and all(bool(torch.isfinite(g).all()) for g in got)
    assert any(bool((g != 0).any()) for g in got)
