"""The port's ``cornell_box`` and ``veach_bdpt`` presets against the JAX
package's, array for array. The reference's model files are not in the
repository, so small OBJ files with the presets' file names stand in for
them under a temporary ``model_dir``."""
import os

import numpy as np
import pytest

from torch_port_util import flatten
from tuturenderer_tpu.scene import presets as JP
from tuturenderer_tpu_torch.scene import presets as TP

MESHES = {
    "cornellBox": ("floor", "light", "right", "left", "tallbox", "shortbox"),
    # the capitalised veach_sLight.obj: the real file name (main.cpp:49
    # lowercases it)
    "veach_bdpt": ("veach_room", "veach_Llight", "veach_sLight",
                   "veach_table", "veach_glass", "veach_tallLamp",
                   "veach_wallLamp"),
}


def _write_obj(path: str, r: np.random.RandomState, smooth: bool):
    """A random quad and triangle; with vn/vt corners when ``smooth``."""
    v = r.randn(7, 3) * 50.0
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    if smooth:
        n = r.randn(3, 3)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in n]
        lines += [f"vt {u:.6f} {w:.6f}" for u, w in r.rand(4, 2)]
        lines += ["f 1/1/1 2/2/2 3/3/3 4/4/1", "f 5/1/2 6/2/3 7/3/1"]
    else:
        lines += ["f 1 2 3 4", "f 5 6 7"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("model")
    r = np.random.RandomState(7)
    for sub, names in MESHES.items():
        os.makedirs(root / sub)
        for i, name in enumerate(names):
            _write_obj(str(root / sub / f"{name}.obj"), r, smooth=i % 2 == 1)
    return str(root)


@pytest.mark.parametrize("preset,size", [("cornell_box", (24, 20)),
                                         ("veach_bdpt", (20, 15))])
def test_preset_matches_jax(model_dir, preset, size):
    j_scene, j_cam = getattr(JP, preset)(model_dir, *size)
    t_scene, t_cam = getattr(TP, preset)(model_dir, *size, device="cpu")
    for got, want in ((flatten(t_scene), flatten(j_scene)),
                      (flatten(t_cam), flatten(j_cam))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_meshes = len(MESHES["cornellBox" if preset == "cornell_box"
                          else "veach_bdpt"])
    assert t_scene.n_tris == 3 * n_meshes
    assert TP.DEFAULT_MODEL_DIR == JP.DEFAULT_MODEL_DIR


def test_presets_need_their_assets(tmp_path):
    with pytest.raises(FileNotFoundError):
        TP.cornell_box(str(tmp_path), 8, 8, device="cpu")
    with pytest.raises(FileNotFoundError):
        TP.veach_bdpt(str(tmp_path), 8, 8, device="cpu")
