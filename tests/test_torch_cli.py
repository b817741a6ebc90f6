"""The port's CLI (``python -m tuturenderer_tpu_torch``), end to end on the
CPU (``--device cpu``): ``tests/test_cli.py``'s CLI tests in the port,
its PPM of test_cli.py's CONFIG and its estimator grid held to the JAX
package's (stored by ``tests/data/make_torch_shell_refs.py``), and the
entry point run in a subprocess with no jax loaded."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_cli import CONFIG, INVERT_CONFIG
from torch_port_util import SHELL_REFS, assert_at_bar
from tuturenderer_tpu_torch.cli import WAVEFRONT_LANES, main
from tuturenderer_tpu_torch.io.ppm import read_ppm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def config_path(tmp_path):
    p = tmp_path / "scene.txt"
    p.write_text(CONFIG)
    return str(p)


def test_cli_renders_ppm(config_path, capsys):
    out = config_path[:-4] + ".ppm"
    main([config_path, "--spp", "2", "--max-depth", "2", *CPU])
    assert os.path.exists(out)
    assert read_ppm(out).shape == (16, 16, 3)
    assert "successfully" in capsys.readouterr().out


def test_cli_ppm_matches_jax_cli(config_path, tmp_path):
    """The port's PPM of CONFIG against the JAX CLI's: within one 8-bit
    level everywhere, equal on >= 99 % of the values."""
    stored = np.load(SHELL_REFS["cli-ppm"])
    argv = json.loads(str(stored["case"]))["argv"]
    out = str(tmp_path / "port.ppm")
    main([config_path, *argv, "-o", out, *CPU])
    got = np.rint(read_ppm(out) * 255).astype(np.int32)
    want = stored["ppm"].astype(np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.99, (got == want).mean()


def test_cli_profile_and_png(config_path, tmp_path, capsys):
    out = str(tmp_path / "o.png")
    main([config_path, "--spp", "2", "--max-depth", "2", "--profile",
          "-o", out, *CPU])
    assert os.path.exists(out)
    captured = capsys.readouterr()
    assert "render" in captured.err and "scene build" in captured.err
    assert "M paths/s" in captured.out


def test_cli_trace_dir(config_path, tmp_path):
    """--trace-dir writes the profiler's Chrome trace, with the render's
    host operators in it."""
    trace_dir = tmp_path / "trace"
    main([config_path, "--spp", "1", "--max-depth", "1", "--trace-dir",
          str(trace_dir), "-o", str(tmp_path / "o.ppm"), *CPU])
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cli_checkpoint_resume(config_path, tmp_path, capsys):
    ck = str(tmp_path / "film.npz")
    out1 = str(tmp_path / "a.ppm")
    out2 = str(tmp_path / "b.ppm")
    main([config_path, "--spp", "4", "--chunk-spp", "2",
          "--checkpoint", ck, "-o", out1, *CPU])
    assert int(np.load(ck)["spp_done"]) == 4
    main([config_path, "--spp", "4", "--chunk-spp", "2",
          "--checkpoint", ck, "-o", out2, *CPU])
    assert "resumed at 4/4 spp" in capsys.readouterr().out
    np.testing.assert_array_equal(read_ppm(out1), read_ppm(out2))


def test_cli_estimator_grid(config_path, tmp_path):
    out = str(tmp_path / "grid.ppm")
    main([config_path, "--spp", "2", "--max-depth", "2",
          "--estimator-grid", "-o", out, *CPU])
    assert read_ppm(out).shape == (32, 32, 3)


def test_estimator_grid_matches_jax(config_path):
    """Each pane of the port's grid is its own render_image, and the grid
    equals JAX's estimator_grid at the stored-render bar."""
    import dataclasses

    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.render import estimator_grid, render_image
    from tuturenderer_tpu_torch.scene.config import parse_config
    stored = np.load(SHELL_REFS["grid"])
    case = json.loads(str(stored["case"]))
    pc = parse_config(config_path)
    scene, cam = pc.builder.build(device="cpu"), pc.camera(device="cpu")
    opts = RenderOptions(**case["options"])
    grid = estimator_grid(scene, cam, opts, seed=case["seed"])
    h, w = cam.height, cam.width
    panes = {(0, 0): ("naivept", opts), (0, 1): ("light", opts),
             (1, 0): ("path", dataclasses.replace(opts, mis=False)),
             (1, 1): ("path", dataclasses.replace(opts, mis=True))}
    for (r, c), (integrator, o) in panes.items():
        np.testing.assert_array_equal(
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w],
            render_image(scene, cam, o, integrator, seed=case["seed"]))
    assert_at_bar(grid, stored["image"])


def test_cli_raster_check(config_path, tmp_path):
    out = str(tmp_path / "raster.ppm")
    main([config_path, "--spp", "1", "--raster-check", "-o", out, *CPU])
    img = read_ppm(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_cli_batches_samples_into_wavefronts():
    from tuturenderer_tpu_torch.cli import samples_per_launch
    assert samples_per_launch(2, 16 * 16) == 2
    assert samples_per_launch(64, 128 * 128) == 64
    assert samples_per_launch(64, 512 * 512) == WAVEFRONT_LANES // (512 * 512)
    assert samples_per_launch(16, 1024 * 1024) == 1
    assert samples_per_launch(8, 2048 * 2048) == 1


def test_cli_defaults_to_the_card(config_path):
    """Without --device the CLI renders on the card; with none, it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([config_path, "--spp", "1"])


def test_mtlcolor_preserves_material_type(tmp_path):
    """mtlcolor sets only diffuse/specular/alpha/eta: the material type
    (and roughness/metallic) persists until the next material keyword
    (PPMGenerator.hpp:583-609), as in the JAX package."""
    from tuturenderer_tpu_torch.scene.config import ConfigParser
    from tuturenderer_tpu_torch.scene.data import LAMBERTIAN, MICROFACET_R
    cfg = tmp_path / "mtl.txt"
    cfg.write_text("""imsize 8 8
eye 0 0 3
viewdir 0 0 -1
updir 0 1 0
hfov 60
bkgcolor 0 0 0 1.0
integrator path
mtlcolor 0.5 0.5 0.5 1 1 1 1.0 1.0
sphere -1 0 0 0.5
MICROFACET_R 0.8 0.6 0.4 1.0 1.0 0.4 0.3
sphere 0 0 0 0.5
mtlcolor 0.7 0.7 0.7 1 1 1 1.0 1.0
sphere 1 0 0 0.5
""")
    scene = ConfigParser(str(cfg)).parse().builder.build(device="cpu")
    smat = scene.smat.long()
    assert scene.materials.mtype[smat].tolist() == [LAMBERTIAN, MICROFACET_R,
                                                    MICROFACET_R]
    assert abs(float(scene.materials.roughness[smat[2]]) - 0.4) < 1e-6
    assert abs(float(scene.materials.diffuse.x[smat[2]]) - 0.7) < 1e-6


def test_cli_inverse_rendering_recovers_albedo(tmp_path, capsys):
    """--invert: from a wrong albedo, SGD against the target drives the
    loss below 0.05 of its first value and moves the re-render toward the
    target."""
    true_cfg = tmp_path / "true.txt"
    true_cfg.write_text(INVERT_CONFIG)
    wrong_cfg = tmp_path / "wrong.txt"
    wrong_cfg.write_text(INVERT_CONFIG.replace("mtlcolor 0.8 0.2 0.2",
                                               "mtlcolor 0.2 0.6 0.7"))
    args = ["--spp", "4", "--max-depth", "2", *CPU]
    target = str(tmp_path / "target.ppm")
    main([str(true_cfg), *args, "-o", target])
    base = str(tmp_path / "base.ppm")
    main([str(wrong_cfg), *args, "-o", base])
    capsys.readouterr()

    out = str(tmp_path / "recovered.ppm")
    main([str(wrong_cfg), *args, "--invert", target, "--invert-steps", "40",
          "--invert-lr", "10.0", "-o", out])
    text = capsys.readouterr().out
    losses = [float(ln.split("loss")[1]) for ln in text.splitlines()
              if ln.startswith("invert step")]
    assert len(losses) == 5          # steps 0, 10, 20, 30 and 39
    assert losses[-1] < 0.05 * losses[0], losses
    assert "invert material[0] diffuse = " in text
    lin = lambda p: read_ppm(p) ** (1.0 / 0.78)
    t = lin(target)
    d_base = np.abs(lin(base) - t).mean()
    d_rec = np.abs(lin(out) - t).mean()
    assert d_rec < 0.8 * d_base, (d_rec, d_base, losses)


def test_cli_runs_without_jax(tmp_path):
    """``python -m tuturenderer_tpu_torch --help``, and a CPU render
    through the module's entry point, with no jax and no JAX-package
    module loaded."""
    help_out = subprocess.run(
        [sys.executable, "-m", "tuturenderer_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert help_out.returncode == 0, help_out.stderr
    assert "--device" in help_out.stdout and "--invert" in help_out.stdout
    cfg = tmp_path / "scene.txt"
    cfg.write_text(CONFIG)
    out = tmp_path / "o.ppm"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tuturenderer_tpu_torch', {str(cfg)!r}, '--spp', '1',"
        f" '--max-depth', '1', '--device', 'cpu', '-o', {str(out)!r}]\n"
        "runpy.run_module('tuturenderer_tpu_torch', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'tuturenderer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().endswith("ok")
    assert read_ppm(str(out)).shape == (16, 16, 3)
