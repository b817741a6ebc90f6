"""Compaction lane for lane without overflow: the port's compacted render
against the JAX package's on simple_box at 80x64 (5,120 lanes, both fed
the scene tables JAX builds, the JAX side through its dense Pallas kernels
in interpret mode), 4 spp, seed 3, the MIS estimator, under the roomy
schedule (1.0, 0.5); and the compacted render against the uncompacted one.
The JAX render is the one ``tests/data/make_torch_integrator_refs.py``
stores for chip_smoke.py. The bar is ``test_torch_compaction_jax.py``'s.
"""
import pytest
import torch

from torch_port_util import (REF_SEED, check_compacted_render,
                             check_stored_reference, compact_port_box,
                             integrator_fields, jax_integrator_render)
from tuturenderer_tpu_torch.integrators.path import render
from tuturenderer_tpu_torch.options import RenderOptions

NAME = "compact-mis"


@pytest.fixture(scope="module")
def jax_render():
    return jax_integrator_render(NAME)


def test_stored_compaction_reference_is_the_jax_render(jax_render):
    """chip_smoke.py holds the card's render against it."""
    check_stored_reference(NAME, jax_render)


def test_compacted_render_matches_jax(jax_render):
    assert check_compacted_render(NAME, jax_render,
                                  *compact_port_box()) == 0


def test_roomy_compaction_equals_the_uncompacted_render():
    """Without overflow a compacted render is the uncompacted one up to
    the order of float additions (a lane's radiance is summed in two
    parts, flushed at the shrink and after the last bounce): rtol 1e-5 /
    atol 1e-6."""
    scene, cam = compact_port_box()
    opts = RenderOptions(**dict(integrator_fields(NAME), spp=2))
    img, st = render(scene, cam, opts, REF_SEED, stats=True)
    assert int(st["compaction_overflow"]) == 0
    plain = render(scene, cam, RenderOptions(spp=2), REF_SEED)
    torch.testing.assert_close(img, plain, rtol=1e-5, atol=1e-6)
