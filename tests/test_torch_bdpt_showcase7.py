"""The stored JAX render at the default bdpt_max_path_length 7, the length
of every BDPT path on the card, equals a fresh JAX render
(``bdpt-showcase-7``: sphere_showcase(24, 20, nu=46, nv=46), 4,236
triangles, 4 spp, seed 3, on the JAX package's CPU route), as
``tests/data/make_torch_integrator_refs.py`` stores it for chip_smoke.py.
The JAX graph compiles for most of this file's time, so the file holds this
check alone; test_torch_bdpt.py holds the port's render to the stored one.
"""
from torch_port_util import check_stored_reference, jax_integrator_render


def test_stored_bdpt_length7_reference_is_the_jax_render():
    check_stored_reference("bdpt-showcase-7",
                           jax_integrator_render("bdpt-showcase-7"))
