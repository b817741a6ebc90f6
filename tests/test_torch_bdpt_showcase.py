"""BDPT of the PyTorch port at mesh scale against the JAX package's render
that ``tests/data/make_torch_integrator_refs.py`` stores for chip_smoke.py
(``bdpt-showcase``: sphere_showcase(24, 20, nu=46, nv=46), 4,236 triangles
with cluster tables, 4 spp at bdpt_max_path_length 5, seed 3).
Each package builds the scene itself; the JAX side takes its CPU route (its
XLA BVH), the port its cluster wrappers, whose plain versions run on the
CPU (K5/K6 on the card). Tolerance as in test_torch_bdpt_box.py.
"""
import pytest

from torch_port_util import (INTEGRATOR_CASES, REF_SEED, assert_at_bar,
                             check_stored_reference, integrator_fields,
                             jax_integrator_render, port_scene)
from tuturenderer_tpu_torch.integrators import bdpt as B
from tuturenderer_tpu_torch.options import RenderOptions

NAME = "bdpt-showcase"


@pytest.fixture(scope="module")
def jax_render():
    return jax_integrator_render(NAME)


def test_stored_bdpt_showcase_reference_is_the_jax_render(jax_render):
    check_stored_reference(NAME, jax_render)


def test_render_matches_jax(jax_render):
    scene, cam = port_scene(INTEGRATOR_CASES[NAME][1])
    assert scene.clusters is not None and scene.n_tris == 4236
    img = B.render(scene, cam, RenderOptions(**integrator_fields(NAME)),
                   REF_SEED).numpy()
    assert_at_bar(img, jax_render["image"])
    assert jax_render["image"].mean() > 0.05
