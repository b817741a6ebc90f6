"""The PyTorch port's differentiable BDPT renderer
(``grad.render_bdpt_diff``) against the JAX package's.

- against the stored JAX computation (``bdpt-diffuse`` of GRAD_CASES:
  tests/test_grad.py's diffuse_box at a 24x20 camera, 4 spp,
  bdpt_max_path_length 4, seed 7): the image and the gradient of its mean
  for every MaterialParams leaf, at the tolerances of
  test_torch_bdpt_light_grad.py (the port in its Moller-Trumbore form, as
  the JAX package's CPU route computes).

(tests/test_grad.py's finite-difference check, on the port:
test_torch_bdpt.py.)
"""
import pytest

from test_torch_bdpt_light_grad import check_against_jax
from torch_port_util import GRAD_REFS, check_stored, grad_case, jax_grad_case
from tuturenderer_tpu_torch import grad as G
from tuturenderer_tpu_torch.ops import intersect as TI

NAME = "bdpt-diffuse"


@pytest.fixture(autouse=True)
def port_mt(monkeypatch):
    monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")


@pytest.fixture(scope="module")
def jax_case():
    return jax_grad_case(NAME)


def test_stored_bdpt_gradient_reference_is_the_jax_computation(jax_case):
    check_stored(GRAD_REFS[NAME], jax_case, grad_case(NAME), rtol=1e-6)


def test_image_and_gradients_match_jax(jax_case):
    check_against_jax(G.render_bdpt_diff, NAME, jax_case)
