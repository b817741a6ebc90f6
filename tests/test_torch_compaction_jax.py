"""Compaction lane for lane under overflow: the port's compacted render
against the JAX package's on simple_box at 80x64 (5,120 lanes, both fed
the scene tables JAX builds, the JAX side through its dense Pallas kernels
in interpret mode), 4 spp, seed 3, the MIS estimator, under the tight
schedule (1.0, 0.25): the overflow roulette engages. The JAX render is the
one ``tests/data/make_torch_integrator_refs.py`` stores for chip_smoke.py
(``test_torch_compaction_roomy.py`` has the roomy schedule).

Both packages draw the same roulette keys and sort them stably, so with
the same live lanes at each shrink the same lanes survive with the same
upweight: the overflow count is equal, and the image is held at the path
tracer's bar (>= 99 % of pixels within rtol 1e-4 / atol 1e-5, the mean
within 0.5 %). The frame is not square: a square one puts simple_box's
pixel centres on its quads' diagonals, where the two packages can split a
camera ray differently; one live lane more or less then changes every
survivor's weight.
"""
import pytest

from torch_port_util import (check_compacted_render, check_stored_reference,
                             compact_port_box, jax_integrator_render)

NAME = "compact-overflow"


@pytest.fixture(scope="module")
def jax_render():
    return jax_integrator_render(NAME)


def test_stored_compaction_reference_is_the_jax_render(jax_render):
    """chip_smoke.py holds the card's render against it."""
    check_stored_reference(NAME, jax_render)


def test_compacted_render_matches_jax(jax_render):
    over = check_compacted_render(NAME, jax_render, *compact_port_box())
    assert over > 0
