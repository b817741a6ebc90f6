"""BDPT of the PyTorch port on simple_box against the JAX package's render
that ``tests/data/make_torch_integrator_refs.py`` stores for chip_smoke.py
(``bdpt-box``: 24x20 x 4 spp, bdpt_max_path_length 3, seed 3). Both are fed
the scene tables JAX builds; the JAX side takes its dense Pallas Woop
kernels in interpret mode, the kernels whose CUDA counterparts K1/K2 the
port's dense route launches on the card (on the CPU their plain versions).

Tolerance: >= 99 % of pixels within rtol 1e-4 / atol 1e-5 and the image
mean within 0.5 % (``assert_at_bar``): both packages draw the same numbers
on every lane, and a threshold compare can flip on a 1-ulp difference of a
transcendental and send a path elsewhere.
"""
import pytest

from torch_port_util import (INTEGRATOR_CASES, REF_SEED, assert_at_bar,
                             check_stored_reference, integrator_fields,
                             jax_integrator_render, port_scene)
from tuturenderer_tpu_torch.integrators import bdpt as B
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.ops.cuda import intersect as K
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_image

NAME = "bdpt-box"


@pytest.fixture(scope="module")
def jax_render():
    return jax_integrator_render(NAME)


def test_stored_bdpt_box_reference_is_the_jax_render(jax_render):
    check_stored_reference(NAME, jax_render)


def test_render_matches_jax(jax_render, monkeypatch):
    """Through render_image, as a config with ``integrator bdpt`` is; the
    dense route's nearest hit is called bdpt_max_path_length eye steps plus
    bdpt_max_path_length - 1 light steps times, the any hit once, per
    sample."""
    scene, cam = port_scene(INTEGRATOR_CASES[NAME][1])
    assert scene.clusters is None
    opts = RenderOptions(**integrator_fields(NAME))
    calls = {"near": 0, "occ": 0}
    near, occ = K.tri_intersect, K.tri_occluded

    def count(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(TI, "tri_intersect", count("near", near))
    monkeypatch.setattr(TI, "tri_occluded", count("occ", occ))
    img = render_image(scene, cam, opts, integrator="bdpt", seed=REF_SEED)
    n = opts.bdpt_max_path_length
    assert calls == {"near": (2 * n - 1) * opts.spp, "occ": opts.spp}
    assert_at_bar(img, jax_render["image"])
    assert jax_render["image"].mean() > 0.1
    torch_img = B.render(scene, cam, opts, REF_SEED).numpy()
    assert (torch_img == img).all()
