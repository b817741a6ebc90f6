"""The port's progressive rendering (``render.render_progressive``): chunked
renders with a film checkpoint, held to the port's single-shot render
(``tests/test_cli.py``'s ``test_progressive_*``, in the port, all four
integrators) and, resuming checkpoints that the JAX package's
``render_progressive`` wrote, to the stored JAX renders they continue."""
import dataclasses

import numpy as np
import pytest

from torch_port_util import (REF_SEED, REF_SIZE, REF_SPP, SHELL_REFS,
                             assert_at_bar, flatten, resumed_image)
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_image, render_progressive
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.scene.presets import simple_box

CHECKPOINT_KEYS = ("film", "spp_done", "seed", "direct", "dmask")


@pytest.fixture(scope="module")
def box():
    """tests/test_grad.py's diffuse_box(16), from the tables JAX builds."""
    from test_grad import diffuse_box
    scene, cam = diffuse_box(16)
    return scene_from_numpy(flatten(scene), device="cpu"), \
        camera_from_numpy(flatten(cam), device="cpu")


@pytest.mark.parametrize("integrator,opts", [
    ("path", RenderOptions(spp=6, max_depth=2)),
    ("light", RenderOptions(spp=6, lt_max_depth=2)),
])
def test_progressive_interrupted_resume(box, tmp_path, integrator, opts):
    """A render that stops after 2 of 6 spp resumes from its checkpoint at
    2 spp and finishes equal to the uninterrupted single shot."""
    scene, cam = box
    one = render_image(scene, cam, opts, integrator, seed=9)
    ck = str(tmp_path / f"crash_{integrator}.npz")
    render_progressive(scene, cam, dataclasses.replace(opts, spp=2),
                       integrator, seed=9, chunk_spp=2, checkpoint_path=ck,
                       progress=False)
    assert int(np.load(ck)["spp_done"]) == 2
    prog = render_progressive(scene, cam, opts, integrator, seed=9,
                              chunk_spp=2, checkpoint_path=ck,
                              progress=False)
    assert int(np.load(ck)["spp_done"]) == opts.spp
    np.testing.assert_allclose(prog, one, rtol=2e-4, atol=2e-6,
                               err_msg=integrator)


@pytest.mark.parametrize("integrator,opts", [
    ("path", RenderOptions(spp=4, max_depth=2)),
    ("naivept", RenderOptions(spp=4, lt_max_depth=2)),
    ("light", RenderOptions(spp=4, lt_max_depth=2)),
    ("bdpt", RenderOptions(spp=4, bdpt_max_path_length=3)),
])
def test_progressive_matches_single_shot_all_integrators(box, tmp_path,
                                                         integrator, opts):
    scene, cam = box
    one = render_image(scene, cam, opts, integrator, seed=5)
    ck = str(tmp_path / f"{integrator}.npz")
    prog = render_progressive(scene, cam, opts, integrator, seed=5,
                              chunk_spp=2, checkpoint_path=ck,
                              progress=False)
    np.testing.assert_allclose(prog, one, rtol=2e-4, atol=2e-6,
                               err_msg=integrator)
    # the checkpoint has the JAX package's keys and dtypes
    saved = np.load(ck)
    assert sorted(saved.files) == sorted(CHECKPOINT_KEYS)
    assert saved["film"].dtype == saved["direct"].dtype == np.float64
    assert saved["dmask"].dtype == bool
    # resume from the finished checkpoint: no new work, same film
    prog2 = render_progressive(scene, cam, opts, integrator, seed=5,
                               chunk_spp=2, checkpoint_path=ck,
                               progress=False)
    np.testing.assert_allclose(prog2, prog, rtol=1e-6, atol=1e-8,
                               err_msg=integrator)


def test_checkpoint_of_another_seed_is_not_resumed(box, tmp_path, capsys):
    scene, cam = box
    opts = RenderOptions(spp=2, max_depth=1)
    ck = str(tmp_path / "ck.npz")
    render_progressive(scene, cam, opts, seed=1, chunk_spp=2,
                       checkpoint_path=ck)
    assert "resumed" not in capsys.readouterr().out
    got = render_progressive(scene, cam, opts, seed=2, chunk_spp=2,
                             checkpoint_path=ck)
    assert "resumed" not in capsys.readouterr().out
    np.testing.assert_allclose(got, render_image(scene, cam, opts, seed=2),
                               rtol=2e-4, atol=2e-6)
    render_progressive(scene, cam, opts, seed=2, chunk_spp=2,
                       checkpoint_path=ck)
    assert "resumed at 2/2 spp" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["checkpoint-path", "checkpoint-light"])
def test_resumes_a_jax_checkpoint(tmp_path, name):
    """The checkpoint JAX's render_progressive wrote after 2 of 4 spp,
    resumed by the port to 4 spp, equals the stored JAX 4-spp render at
    the stored-render bar."""
    import json
    stored = np.load(SHELL_REFS[name])
    case = json.loads(str(stored["case"]))
    assert int(stored["spp_done"]) == case["spp_done"] == 2
    ck = str(tmp_path / "jax_checkpoint.npz")
    np.savez(ck, **{k: stored[k] for k in CHECKPOINT_KEYS})
    scene, cam = simple_box(*REF_SIZE, device="cpu")
    img = render_progressive(scene, cam, RenderOptions(**case["options"]),
                             case["integrator"], seed=case["seed"],
                             chunk_spp=case["chunk_spp"],
                             checkpoint_path=ck, progress=False)
    assert case["options"]["spp"] == REF_SPP and case["seed"] == REF_SEED
    assert int(np.load(ck)["spp_done"]) == REF_SPP
    assert_at_bar(img, resumed_image(name))
