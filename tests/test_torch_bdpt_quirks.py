"""BDPT of the PyTorch port with both of the reference's quirks off
(``tutu_bdpt_weight_kill=False``: the MIS weights partition unity;
``tutu_bdpt_t1_gate=False``: a lane's light path splats whether or not its
camera ray hit) against the JAX package's render that
``tests/data/make_torch_integrator_refs.py`` stores for chip_smoke.py
(``bdpt-showcase-quirks-off``: sphere_showcase(24, 20, nu=46, nv=46), an
open scene where the t=1 gate matters, 4 spp at bdpt_max_path_length 5,
seed 3; the JAX side on its CPU route). Tolerance as in test_torch_bdpt_box.py.
"""
import numpy as np
import pytest

from torch_port_util import (INTEGRATOR_CASES, INTEGRATOR_REFS, REF_SEED,
                             assert_at_bar, check_stored_reference,
                             integrator_fields, jax_integrator_render,
                             port_scene)
from tuturenderer_tpu_torch.integrators import bdpt as B
from tuturenderer_tpu_torch.options import RenderOptions

NAME = "bdpt-showcase-quirks-off"


@pytest.fixture(scope="module")
def jax_render():
    return jax_integrator_render(NAME)


def test_stored_bdpt_quirks_off_reference_is_the_jax_render(jax_render):
    check_stored_reference(NAME, jax_render)


def test_render_matches_jax(jax_render):
    scene, cam = port_scene(INTEGRATOR_CASES[NAME][1])
    img = B.render(scene, cam, RenderOptions(**integrator_fields(NAME)),
                   REF_SEED).numpy()
    assert_at_bar(img, jax_render["image"])


def test_quirks_off_keeps_the_energy_the_quirks_drop():
    """The stored renders of the same case with and without the quirks:
    the weight kill and the t=1 gate only ever drop energy, so the image
    with both off is brighter, pixel for pixel up to float order."""
    on = np.load(INTEGRATOR_REFS["bdpt-showcase"])["image"]
    off = np.load(INTEGRATOR_REFS[NAME])["image"]
    assert off.mean() > on.mean() * 1.01
    assert (off >= on - 1e-5).mean() > 0.99
