"""The config entry point of the PyTorch port against the JAX package: the
config parser (``scene/config.py``), PPM/PNG I/O (``io/ppm.py``), the OBJ
loader (``scene/objloader.py``) and ``render.py``'s refusals. No render of
the JAX package runs here (``test_torch_config_render.py`` has those).

Tolerance: exact. Parsing, the host-side scene build, quantization and
the loaders are the same numpy code in both packages, so every array is
bit-equal and every error message the same.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import flatten, golden_config
from tuturenderer_tpu.io import ppm as JPPM
from tuturenderer_tpu.scene import objloader as JOBJ
from tuturenderer_tpu.scene.config import parse_config as j_parse
from tuturenderer_tpu_torch.camera import camera_from_numpy
from tuturenderer_tpu_torch.io import ppm as PPM
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.render import render_config, render_image
from tuturenderer_tpu_torch.scene import objloader as OBJ
from tuturenderer_tpu_torch.scene.config import (INTEGRATORS, ParsedConfig,
                                                 parse_config)
from tuturenderer_tpu_torch.scene.data import scene_from_numpy
from tuturenderer_tpu_torch.scene.presets import simple_box

GOLDEN = ["mft_128.txt", "tex_128.txt", "mesh_bdpt_128.txt"]
FIELDS = ("width", "height", "hfov", "eye", "viewdir", "updir", "bkgcolor",
          "eta", "integrator", "parallel_projection")


@pytest.fixture(scope="module", params=GOLDEN)
def parsed(request, tmp_path_factory):
    """(name, JAX ParsedConfig, JAX scene, port ParsedConfig) of a golden
    config, tex_128's texture paths rewritten to this checkout."""
    path = golden_config(request.param, str(tmp_path_factory.mktemp("cfg")))
    jc = j_parse(path)
    return request.param, jc, jc.builder.build(), parse_config(path)


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_golden_config_builds_the_jax_scene(parsed):
    """The port's parser and builder give, array for array, the scene that
    JAX's builds (fed to the port through ``scene_from_numpy``); a config
    with 4,096 triangles or more carries cluster tables in both."""
    name, _, j_scene, pc = parsed
    port = pc.builder.build(device="cpu")
    from_jax = scene_from_numpy(flatten(j_scene), device="cpu")
    _assert_flat_equal(flatten(port), flatten(from_jax))
    assert port.has_textures == j_scene.has_textures
    assert port.mtype_set == tuple(j_scene.mtype_set)
    assert (port.clusters is None) == (j_scene.clusters is None)
    if name == "mesh_bdpt_128.txt":
        assert port.n_tris == 18244 and port.clusters is not None
    # the JAX tables the port imports, against its own build of them
    for key, want in flatten(j_scene).items():
        if not key.startswith("bvh."):
            np.testing.assert_array_equal(flatten(port)[key], want,
                                          err_msg=key)


def test_parsed_config_fields_and_camera(parsed):
    _, jc, _, pc = parsed
    assert isinstance(pc, ParsedConfig)
    for field in FIELDS:
        assert getattr(pc, field) == getattr(jc, field), field
    cam = pc.camera(device="cpu")
    assert cam.world2raster.device.type == "cpu"
    _assert_flat_equal(flatten(cam),
                       flatten(camera_from_numpy(flatten(jc.camera()),
                                                 device="cpu")))


def test_config_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pc = parse_config(golden_config("mft_128.txt", str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.camera()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.builder.build()


# ------------------------------------------------------------ the grammar

_HEAD = ("imsize 8 6\neye 0 0 3\nviewdir 0 0 -1\nupdir 0 1 0\nhfov 50\n"
         "bkgcolor 0.1 0.2 0.3 1.0\n")
_TEX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "tex")
_GRAMMAR = {
    # the four face-corner forms, inline spheres and the material machine
    "faces": _HEAD + (
        "integrator naivept\nprojection parallel\nlight 1 1 1 0 0 1 1\n"
        "attlight 1 1 1 0 0 1 1 1 1 1\ndepthcueing 1 1 1 1 1 1 1\n"
        "mtlcolor 0.5 0.4 0.3 1 1 1 0.7 1.3\nemission 4 4 4\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 2\nvn 0 1 1\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "f 1 2 3\nf 1//1 2//1 3//2\nf 1/1 2/2 3/3\nf 1/1/1 2/2/2 4/3/1\n"
        "MICROFACET_R 0.8 0.6 0.4 1.0 1.0 0.4 0.3\nsphere 0 0 -1 0.5\n"
        "mtlcolor 0.2 0.2 0.2 1 1 1 1 1\nsphere 1 0 -1 0.25\n"
        "PERFECT_REFRACTIVE 1.5\nsphere 2 0 -1 0.25\n"
        "PERFECT_REFLECTIVE\nf 1 2 4\nMICROFACET_T 0.9 0.9 0.9 0.5 1.5 "
        "0.2 0.1\nf 2 3 4\n"),
    # texture bindings: bump/rough/metal apply to ONE primitive, then
    # lapse; the diffuse map stays until the next mtlcolor; names dedup
    "textures": _HEAD + (
        "integrator light\nmtlcolor 0.9 0.9 0.9 1 1 1 1 1\n"
        f"texture {_TEX}/checker.ppm\nbump {_TEX}/bump.ppm\n"
        f"roughnessTexture {_TEX}/rough.ppm\n"
        f"metallicTexture {_TEX}/metal.ppm\n"
        "sphere 0 0 -1 0.5\nsphere 1 0 -1 0.5\n"
        f"texture {_TEX}/checker.ppm\nsphere 2 0 -1 0.5\n"
        "mtlcolor 0.9 0.9 0.9 1 1 1 1 1\nsphere 3 0 -1 0.5\n"),
}
_ERRORS = {
    "extraneous": (_HEAD + "integrator path\nbogus 1\n",
                   "extraneous string in the input file: bogus"),
    "face": (_HEAD + "integrator path\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
             "f 1/ 2 3\n", "f face information is not valid"),
    "integrator": (_HEAD + "integrator whitted\n", "unknown integrator"),
    "missing": ("imsize 8 6\neye 0 0 3\nintegrator path\n",
                "insufficient input data: unable to start"),
    "truncated": (_HEAD + "integrator path\nsphere 0 0\n",
                  "Insufficient or invalid data as input"),
}


def _write(tmp_path, text: str) -> str:
    path = tmp_path / "scene.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name", sorted(_GRAMMAR))
def test_config_grammar_matches_jax(tmp_path, name):
    path = _write(tmp_path, _GRAMMAR[name])
    jc, pc = j_parse(path), parse_config(path)
    for field in FIELDS:
        assert getattr(pc, field) == getattr(jc, field), field
    j_scene = jc.builder.build()
    _assert_flat_equal(flatten(pc.builder.build(device="cpu")),
                       flatten(scene_from_numpy(flatten(j_scene),
                                                device="cpu")))
    if name == "textures":
        m = pc.builder._mat
        # bump/rough/metal only on the first sphere; the second and third
        # share a material; the fourth has no texture
        assert m["nmap"] == m["rmap"] == m["mmap"] == [0, -1, -1]
        assert m["dmap"] == [0, 0, -1]
        assert len(pc.builder.textures["diffuse"]) == 1
        # normal maps decoded to [-1, 1]
        nrm = pc.builder.textures["normal"][0]
        np.testing.assert_array_equal(
            nrm, PPM.read_ppm(f"{_TEX}/bump.ppm") * 2.0 - 1.0)
    else:
        assert pc.parallel_projection and pc.integrator == "naivept"


@pytest.mark.parametrize("name", sorted(_ERRORS))
def test_config_errors_match_jax(tmp_path, name):
    text, message = _ERRORS[name]
    path = _write(tmp_path, text)
    with pytest.raises(ValueError) as j_err:
        j_parse(path)
    with pytest.raises(ValueError) as p_err:
        parse_config(path)
    assert str(p_err.value) == str(j_err.value) == message


def test_integrator_table():
    from tuturenderer_tpu.scene.config import INTEGRATORS as J_INTEGRATORS
    assert INTEGRATORS == J_INTEGRATORS


# -------------------------------------------------------------- image I/O

def _image():
    r = np.random.RandomState(4)
    img = (r.rand(7, 9, 3) * 1.3 - 0.1).astype(np.float32)
    img[1, 2, 0] = np.nan
    img[3, 4, 1] = np.inf
    img[5, 6, 2] = -np.inf
    return img


def test_quantize_and_ppm_round_trip_equal_jax(tmp_path, capsys):
    img = _image()
    for gamma in (0.78, 1.0):
        np.testing.assert_array_equal(PPM.quantize(img, gamma),
                                      JPPM.quantize(img, gamma))
    capsys.readouterr()
    PPM.write_ppm(str(tmp_path / "port.ppm"), img)
    JPPM.write_ppm(str(tmp_path / "jax.ppm"), img)
    # NaN/inf pixels are reported, as writePixel does
    assert "2, 1 is nan/inf" in capsys.readouterr().out
    assert (tmp_path / "port.ppm").read_text() == \
        (tmp_path / "jax.ppm").read_text()
    back = PPM.read_ppm(str(tmp_path / "port.ppm"))
    np.testing.assert_array_equal(back,
                                  JPPM.read_ppm(str(tmp_path / "port.ppm")))
    np.testing.assert_array_equal(back, PPM.quantize(img) / np.float32(255))
    golden = os.path.join(os.path.dirname(_TEX), "mft_128_ref.ppm")
    np.testing.assert_array_equal(PPM.read_ppm(golden),
                                  JPPM.read_ppm(golden))
    (tmp_path / "bad.ppm").write_text("P6\n1\n1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="expected P3 header"):
        PPM.read_ppm(str(tmp_path / "bad.ppm"))


def test_png_round_trip_equals_jax(tmp_path):
    pytest.importorskip("PIL")
    img = _image()
    PPM.write_png(str(tmp_path / "port.png"), img)
    JPPM.write_png(str(tmp_path / "jax.png"), img)
    np.testing.assert_array_equal(PPM.read_png(str(tmp_path / "port.png")),
                                  JPPM.read_png(str(tmp_path / "jax.png")))


# --------------------------------------------------------------- OBJ files

OBJ_TEXT = """
# a quad (fan-triangulated), a triangle without normals or uvs, and
# negative (relative) indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
v 0 0 1
v 2 0 1
v 0 3 1
f 5 6 7
f -3//1 -2//1 -1//1
f -3/-4 -2/-3 -1/-2
"""


def test_obj_loader_matches_jax(tmp_path):
    path = str(tmp_path / "mesh.obj")
    with open(path, "w") as f:
        f.write(OBJ_TEXT)
    got, want = OBJ._load_obj_py(path), JOBJ._load_obj_py(path)
    assert got.verts.shape == (5, 3, 3)
    for a, b in ((got.verts, want.verts), (got.normals, want.normals),
                 (got.uvs, want.uvs)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the native loader, taken first, reads the parser's arrays, as the JAX
    # package's load_obj does; prefer_native=False takes the parser
    np.testing.assert_array_equal(OBJ.load_obj(path).verts, got.verts)
    np.testing.assert_array_equal(OBJ.load_obj(path).verts,
                                  JOBJ.load_obj(path).verts)
    np.testing.assert_array_equal(
        OBJ.load_obj(path, prefer_native=False).normals, got.normals)
    for op in (("translate", 1.0, -2.0, 0.5), ("scale", 2.0, 0.5, 3.0),
               ("rotate", 0, 30.0), ("rotate", 1, -45.0), ("rotate", 2, 90.0),
               ("rotate", 1, 0.0)):
        a = getattr(OBJ._load_obj_py(path), op[0])(*op[1:])
        b = getattr(JOBJ._load_obj_py(path), op[0])(*op[1:])
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.normals, b.normals)
    (tmp_path / "empty.obj").write_text("# nothing\n")
    empty = OBJ._load_obj_py(str(tmp_path / "empty.obj"))
    assert empty.verts.shape == (0, 3, 3) and empty.uvs.shape == (0, 3, 2)


# ------------------------------------------------------------- render.py

def test_render_image_refuses_an_unknown_integrator():
    """(postprocess: tests/test_torch_post.py)"""
    scene, cam = simple_box(8, 6, device="cpu")
    with pytest.raises(ValueError, match="unknown integrator 'whitted'"):
        render_image(scene, cam, RenderOptions(spp=1), integrator="whitted")


def test_render_config_of_a_bdpt_config_raises(tmp_path):
    """A config with ``integrator bdpt`` no longer raises (ROADMAP item
    12b landed): render_config renders it with integrators/bdpt.py."""
    from tuturenderer_tpu_torch.integrators.bdpt import render as bdpt
    from tuturenderer_tpu_torch.scene.config import parse_config
    path = _write(tmp_path, _HEAD + "integrator bdpt\nmtlcolor 0.5 0.4 0.3 "
                  "1 1 1 0.7 1.3\nv -1 -1 0\nv 1 -1 0\nv 0 1 0\nf 1 2 3\n")
    opts = RenderOptions(spp=1, bdpt_max_path_length=2)
    img = render_config(path, opts, seed=2, verbose=False, device="cpu")
    pc = parse_config(path)
    assert pc.integrator == "bdpt"
    want = bdpt(pc.builder.build(device="cpu"), pc.camera(device="cpu"),
                opts, 2).numpy()
    np.testing.assert_array_equal(img, want)


def test_config_entry_point_imports_no_jax():
    """render_config from a config file, on the CPU, with no jax and no
    JAX-package module loaded."""
    code = (
        "import sys, os, tempfile, numpy as np\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_port_util import golden_config\n"
        "from tuturenderer_tpu_torch.render import render_config\n"
        "from tuturenderer_tpu_torch.options import RenderOptions\n"
        "import tuturenderer_tpu_torch.integrators.light\n"
        "import tuturenderer_tpu_torch.integrators.naive\n"
        "import tuturenderer_tpu_torch.scene.objloader\n"
        "import tuturenderer_tpu_torch.io.ppm as ppm\n"
        "p = golden_config('tex_128.txt', tempfile.mkdtemp(), (8, 6))\n"
        "img = render_config(p, RenderOptions(spp=1, max_depth=1),\n"
        "                    verbose=False, device='cpu')\n"
        "assert img.shape == (6, 8, 3) and np.isfinite(img).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'tuturenderer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
