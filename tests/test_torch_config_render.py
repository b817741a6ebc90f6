"""``render_config`` of the PyTorch port against the JAX package's, on the
two reference-renderer oracle configs the path tracer serves
(``golden/mft_128.txt``: a MICROFACET_T sphere; ``golden/tex_128.txt``:
diffuse, normal, roughness and metallic maps), each at 24x20 (the
``imsize`` rewritten in a copy) x 4 spp, seed 3, under the oracle quirk
profile of ``tests/test_golden.py``. The JAX side takes its dense Pallas
kernels in interpret mode, the kernels the port's K1/K2 replace.

Tolerance: the path tracer's (``tests/test_torch_path.py``): >= 99 % of
pixels within rtol 1e-4 / atol 1e-5 and the image mean within 0.5 %; the
two packages draw the same random numbers, but a threshold compare can
flip on a 1-ulp difference of a transcendental.
"""
import dataclasses

import numpy as np
import pytest

from torch_port_util import (REF_SEED, REF_SIZE, REF_SPP, golden_config,
                             jax_dense_pallas_interpret)
from tuturenderer_tpu.options import RenderOptions as JOptions
from tuturenderer_tpu.render import render_config as j_render_config
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_config, render_image
from tuturenderer_tpu_torch.scene.presets import simple_box

ORACLE = dict(tutu_light_pick=True, tutu_tri_sample=True,
              ggx_sample_bug=True)


@pytest.fixture(scope="module", params=["mft_128.txt", "tex_128.txt"])
def config_render(request, tmp_path_factory):
    path = golden_config(request.param, str(tmp_path_factory.mktemp("cfg")),
                         REF_SIZE)
    with jax_dense_pallas_interpret():
        img = j_render_config(path, JOptions(spp=REF_SPP, **ORACLE),
                              seed=REF_SEED, verbose=False)
    return path, np.asarray(img)


def test_render_config_matches_jax(config_render, capsys):
    path, want = config_render
    got = render_config(path, RenderOptions(spp=REF_SPP, **ORACLE),
                        seed=REF_SEED, device="cpu")
    assert "scene build:" in capsys.readouterr().out
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (REF_SIZE[1], REF_SIZE[0], 3)
    assert np.isfinite(got).all() and want.mean() > 0.01
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(got.mean() - want.mean()) <= 0.005 * want.mean()


def test_samples_per_launch_keeps_the_config_render(config_render):
    """The chip's golden phase renders with samples_per_launch = spp: the
    same image as one sample per launch."""
    path = config_render[0]
    opts = RenderOptions(spp=REF_SPP, **ORACLE)
    one = render_config(path, opts, seed=REF_SEED, verbose=False,
                        device="cpu")
    batched = render_config(
        path, dataclasses.replace(opts, samples_per_launch=REF_SPP),
        seed=REF_SEED, verbose=False, device="cpu")
    np.testing.assert_allclose(batched, one, rtol=1e-5, atol=1e-6)


def test_render_image_reports_compaction_overflow(capsys):
    """Under compaction, render_image reads the overflow count once the
    image is on the host and reports a nonzero one on stderr."""
    scene, cam = simple_box(64, 48, device="cpu")
    tight = RenderOptions(spp=1, max_depth=2, compaction=(1.0, 0.25))
    img = render_image(scene, cam, tight, seed=3)
    assert isinstance(img, np.ndarray) and np.isfinite(img).all()
    assert "compaction overflow engaged" in capsys.readouterr().err
    roomy = dataclasses.replace(tight, compaction=(1.0, 1.0))
    render_image(scene, cam, roomy, seed=3)
    assert capsys.readouterr().err == ""
