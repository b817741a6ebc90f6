"""The port's post-processing (``tuturenderer_tpu_torch/post.py``) against
the JAX package's ``post.py`` and the reference math.

Each of ``tests/test_post.py``'s seven tests, in the port: the same numpy
input goes through the JAX function and the port's (within rtol 1e-6) and
the port is held to test_post.py's NumPy transcription of
Postprocessor.hpp at its bars. The CLI ``--post`` test runs the port's
CLI."""
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per process)
from test_post import ref_blur_once, ref_gauss_weights, ref_pipeline
from tuturenderer_tpu import post as JP
from tuturenderer_tpu_torch import post as TP


def both(name: str, img: np.ndarray) -> np.ndarray:
    """The port's ``name`` of ``img``, held to the JAX package's within
    rtol 1e-6."""
    got = getattr(TP, name)(torch.from_numpy(img)).numpy()
    want = np.asarray(getattr(JP, name)(img))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    return got


def test_constants_and_taps_match_jax_and_reference_formula():
    for c in ("STRENGTH", "GAUSSIANLOOP", "KERNELSIZE", "STDDEV", "EXPOSURE"):
        assert getattr(TP, c) == getattr(JP, c), c
    k, start = TP._gaussian_kernel()
    jk, jstart = JP._gaussian_kernel()
    offs, w = ref_gauss_weights()
    assert start == jstart == offs[0] == -5
    assert k.dtype == torch.float32
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_allclose(k.numpy(), w / w.sum(), rtol=1e-5)


@pytest.mark.parametrize("corner", [False, True])
def test_blur_matches_jax_and_reference(corner):
    """A centre delta, and a corner delta through the clamp-to-edge taps."""
    if corner:
        img = np.zeros((8, 8, 3), np.float32)
        img[0, 0, 0] = 2.0
    else:
        img = np.zeros((9, 9, 3), np.float32)
        img[4, 4, :] = 1.0
    got = both("gaussian_blur", img)
    np.testing.assert_allclose(got, ref_blur_once(img), rtol=1e-5, atol=1e-7)


def test_emissive_extract_thresholds():
    img = np.array([[[4.0, 0.0, 0.0], [1.0, 1.0, 1.0], [3.0, 3.0, 3.0],
                     [0.0, 2.0, 4.0]]], np.float32)
    got = both("extract_emissive", img)
    want = np.array([[[2, 0, 0], [0, 0, 0], [2, 2, 2], [0, 1, 2]]],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_exposure_tonemap_values():
    img = np.array([[[0.0, 1.0, 10.0]]], np.float32)
    got = both("tonemap_exposure", img)
    np.testing.assert_allclose(got, 1.0 - np.exp(-img * 1.5), rtol=1e-6)
    assert got.max() <= 1.0 and got.min() >= 0.0


def test_full_pipeline_matches_jax_and_reference_oracle():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.0, (16, 12, 3)).astype(np.float32)
    img[3:5, 4:6] = 8.0          # an emissive blob to bloom
    got = both("bloom_and_tonemap", img)
    np.testing.assert_allclose(got, ref_pipeline(img.astype(np.float64)),
                               rtol=2e-4, atol=1e-6)
    bloom = both("bloom_only", img)
    assert bloom[10, 10].sum() > img[10, 10].sum()
    np.testing.assert_allclose(both("hdr_only", img),
                               1.0 - np.exp(-img * 1.5), rtol=1e-5,
                               atol=1e-7)


def test_render_image_postprocess(tmp_path):
    """render_image(postprocess=True) is bloom_and_tonemap of the linear
    render, on the scene's device."""
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.render import render_image
    from tuturenderer_tpu_torch.scene.presets import simple_box
    scene, cam = simple_box(12, 10, device="cpu")
    opts = RenderOptions(spp=1, max_depth=1)
    lin = render_image(scene, cam, opts, seed=2)
    got = render_image(scene, cam, opts, seed=2, postprocess=True)
    np.testing.assert_array_equal(got, TP.bloom_and_tonemap(lin).numpy())
    np.testing.assert_allclose(got, ref_pipeline(lin.astype(np.float64)),
                               rtol=2e-4, atol=1e-6)


POST_CONFIG = """imsize 32 32
eye 0 0.35 2.6
viewdir 0 -0.12 -1
updir 0 1 0
hfov 55
bkgcolor 0.05 0.05 0.08 1.0
integrator path
mtlcolor 0.9 0.9 0.9 1 1 1 1.0 1.0
emission 10 10 10
v -0.5 1.4 -0.5
v 0.5 1.4 -0.5
v 0.5 1.4 0.5
v -0.5 1.4 0.5
vn 0 -1 0
f 1//1 2//1 3//1
f 1//1 3//1 4//1
mtlcolor 0.7 0.7 0.7 1 1 1 1.0 1.0
v -2 -0.5 2
v 2 -0.5 2
v 2 -0.5 -2
v -2 -0.5 -2
f 5 6 7
f 5 7 8
"""


def test_cli_post_flag(tmp_path):
    """test_post.py's CLI test (its config), through the port's CLI."""
    cfg = tmp_path / "scene.txt"
    cfg.write_text(POST_CONFIG)
    out = tmp_path / "out.ppm"
    from tuturenderer_tpu_torch.cli import main
    main([str(cfg), "--spp", "2", "--post", "-o", str(out), "--device",
          "cpu"])
    from tuturenderer_tpu_torch.io.ppm import read_ppm
    img = read_ppm(str(out))
    assert np.isfinite(img).all()
    assert img.shape == (32, 32, 3)
