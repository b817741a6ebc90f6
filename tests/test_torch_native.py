"""The port's binding of the native host runtime
(``tuturenderer_tpu_torch/native.py``) against the pure-Python paths and
the JAX package's binding of the same library (``tests/test_native.py``,
in the port)."""
import os

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per process)
from tuturenderer_tpu import native as JN
from tuturenderer_tpu_torch import native as TN
from tuturenderer_tpu_torch.io.ppm import read_ppm
from tuturenderer_tpu_torch.scene.objloader import _load_obj_py, load_obj

OBJ_TEXT = """
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
"""


@pytest.fixture
def obj_path(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(OBJ_TEXT)
    return str(path)


def test_native_obj_matches_python(obj_path):
    nv, nn, nt = TN.obj_load(obj_path)
    py = _load_obj_py(obj_path)
    assert nv.shape == (2, 3, 3)   # quad fan-triangulated
    np.testing.assert_allclose(nv, py.verts)
    np.testing.assert_allclose(nn, py.normals)
    np.testing.assert_allclose(nt, py.uvs)
    # load_obj takes the native loader first; both bindings read the same
    mesh = load_obj(obj_path)
    for got, want in zip((mesh.verts, mesh.normals, mesh.uvs),
                         JN.obj_load(obj_path)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        load_obj(obj_path + ".missing")


def test_native_obj_reference_assets():
    from tuturenderer_tpu_torch.scene.presets import DEFAULT_MODEL_DIR
    path = os.path.join(DEFAULT_MODEL_DIR, "cornellBox", "shortbox.obj")
    if not os.path.exists(path):
        pytest.skip("reference assets not mounted")
    nv, nn, nt = TN.obj_load(path)
    py = _load_obj_py(path)
    np.testing.assert_allclose(nv, py.verts)
    np.testing.assert_allclose(nn, py.normals, atol=1e-6)


def test_native_bvh_valid_partition():
    r = np.random.RandomState(3)
    verts = (r.randn(97, 1, 3) + 0.3 * r.randn(97, 3, 3)).astype(np.float32)
    bvh = TN.bvh_build(verts, leaf_size=4)
    assert sorted(bvh['prim'].tolist()) == list(range(97))
    leaves = bvh['left'] < 0
    assert bvh['count'][leaves].sum() == 97
    for node in np.nonzero(leaves)[0]:
        s, c = bvh['start'][node], bvh['count'][node]
        prims = bvh['prim'][s:s + c]
        lo = verts[prims].reshape(-1, 3).min(axis=0)
        hi = verts[prims].reshape(-1, 3).max(axis=0)
        assert (bvh['bb_min'][node] <= lo + 1e-6).all()
        assert (bvh['bb_max'][node] >= hi - 1e-6).all()
    want = JN.bvh_build(verts, leaf_size=4)
    assert sorted(bvh) == sorted(want)
    for key in bvh:
        np.testing.assert_array_equal(bvh[key], want[key], err_msg=key)


def test_native_ppm_roundtrip(tmp_path):
    img = np.random.RandomState(0).rand(7, 5, 3).astype(np.float32)
    path = str(tmp_path / "img.ppm")
    assert TN.ppm_write(path, img, gamma=1.0)
    back = TN.ppm_read(path)
    assert back.shape == (7, 5, 3)
    np.testing.assert_allclose(back, img, atol=1.0 / 255 + 1e-3)
    # the Python reader and the JAX package's binding read the same
    np.testing.assert_allclose(read_ppm(path), back, atol=1e-6)
    np.testing.assert_array_equal(JN.ppm_read(path), back)
    with pytest.raises(FileNotFoundError):
        TN.ppm_read(path + ".missing")


def test_library_built_from_source_when_the_committed_one_fails(
        tmp_path, monkeypatch):
    """A committed library that will not load is replaced by one built
    from native/host.cpp into the build directory; native/ is not
    written."""
    monkeypatch.setattr(TN, "_COMMITTED", str(tmp_path / "missing.so"))
    monkeypatch.setattr(TN, "_BUILT", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    native_dir = os.path.dirname(TN._SOURCE)
    before = sorted(os.listdir(native_dir))
    lib = TN.load_library()
    assert lib is not None and os.path.exists(TN._BUILT)
    assert sorted(os.listdir(native_dir)) == before
    path = str(tmp_path / "quad.obj")
    with open(path, "w") as f:
        f.write(OBJ_TEXT)
    np.testing.assert_array_equal(TN.obj_load(path)[0],
                                  _load_obj_py(path).verts)
