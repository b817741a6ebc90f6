"""The SPD ``tetra`` generator (``portbench/spd.py``) and the scene the BDPT
loop makes of the ``spd_tetra`` configuration: 4^(SF + 1) triangles, each
face wound outward and none degenerate, each level's tetrahedra exact
half-size copies of their parent at its corners, touching only at points;
and the one set of arrays handed to the program and to the reference."""
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference, scenes, spd
from portbench.loops import bdpt

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "portbench/configs/spd_tetra.json"
SHAPE = dict(size_factor=3, edge=2.0, center=[0.25, -0.5], base_y=0.125)


def _shape(sf: int) -> dict:
    return dict(SHAPE, size_factor=sf)


@pytest.mark.parametrize("sf", [0, 1, 2, 5])
def test_triangle_count(sf):
    tris = spd.tetra_triangles(_shape(sf))
    assert tris.shape == (4 ** (sf + 1), 3, 3) and tris.dtype == np.float32


def test_level0_is_regular_and_stands_on_its_base():
    v = spd.level0(2.0, (0.25, -0.5), 0.125)
    d = [np.linalg.norm(a - b) for a, b in itertools.combinations(v, 2)]
    assert np.allclose(d, 2.0, rtol=0, atol=1e-12)
    assert np.all(v[:3, 1] == 0.125) and v[3, 1] > 0.125
    assert np.allclose(v[:3].mean(0)[[0, 2]], (0.25, -0.5), atol=1e-12)
    assert np.allclose(v[3, [0, 2]], (0.25, -0.5), atol=1e-12)


@pytest.mark.parametrize("sf", [0, 3])
def test_faces_wound_outward_and_not_degenerate(sf):
    tets = spd.tetrahedra(sf, 2.0)
    tri = spd.faces(tets).reshape(len(tets), 4, 3, 3)
    normal = np.cross(tri[..., 1, :] - tri[..., 0, :],
                      tri[..., 2, :] - tri[..., 0, :])
    out = tri.mean(2) - tets.mean(1)[:, None, :]
    assert np.all(np.einsum("nki,nki->nk", normal, out) > 0)
    # every face of every level an equilateral triangle of the level's edge
    edge = 2.0 / 2 ** sf
    for a, b in ((0, 1), (1, 2), (2, 0)):
        assert np.allclose(np.linalg.norm(tri[..., a, :] - tri[..., b, :],
                                          axis=-1), edge, rtol=1e-12)
    f32 = spd.tetra_triangles(dict(SHAPE, size_factor=sf)).astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(f32[:, 1] - f32[:, 0],
                                         f32[:, 2] - f32[:, 0]), axis=1)
    assert area.min() > 0.99 * np.sqrt(3) / 4 * edge ** 2


def test_children_are_half_size_copies_at_the_corners():
    parent = spd.tetrahedra(2, 2.0, (0.25, -0.5), 0.125)
    child = spd.subdivide(parent).reshape(len(parent), 4, 4, 3)
    for c in range(4):
        kid = child[:, c]
        assert np.array_equal(kid[:, c], parent[:, c])
        for j in range(4):
            assert np.array_equal(kid[:, j], 0.5 * (parent[:, c] +
                                                     parent[:, j]))
        assert np.allclose(kid - kid[:, c:c + 1],
                           0.5 * (parent - parent[:, c:c + 1]),
                           rtol=0, atol=1e-15)
    # siblings share exactly one vertex (the midpoint of the edge between
    # their corners) and no more: they touch at points only
    for a, b in itertools.combinations(range(4), 2):
        shared = [(child[:, a, i] == child[:, b, j]).all(-1)
                  for i in range(4) for j in range(4)]
        assert np.array_equal(np.sum(shared, axis=0), np.ones(len(parent)))


def test_the_configuration_is_the_sf8_pyramid_a_ground_and_a_light():
    cfg = scenes.load_json(CONFIG)
    arrays = bdpt.scene_arrays(cfg)
    assert scenes.n_triangles(arrays) == 262_144 + 4
    shapes = [s for s in cfg["scene"]["shapes"] if "spd_tetra" in s]
    assert len(shapes) == 1 and shapes[0]["spd_tetra"]["size_factor"] == 8
    verts, normals, mat = arrays["tris"][-1]
    assert normals is None and verts.shape == (262_144, 3, 3)
    assert arrays["materials"][mat]["mtype"] == \
        scenes.MATERIAL_TYPES["MICROFACET_R"]
    assert arrays["materials"][mat]["roughness"] == 0.2775146484375
    assert arrays["materials"][mat]["metallic"] == 0.5
    emissive = [i for i, m in enumerate(arrays["materials"])
                if any(m["emission"])]
    assert [m for _, _, m in arrays["tris"]].count(emissive[0]) == 1
    assert cfg["reduced"] == [] and cfg["integrator"]["name"] == "bdpt"


def test_one_set_of_arrays_for_the_program_and_the_reference():
    """At SF 3 the loop's arrays are the program's scene (through its
    public builder) and the reference's, triangle for triangle."""
    cfg = scenes.load_json(CONFIG)
    cfg["scene"]["shapes"][0]["spd_tetra"]["size_factor"] = 3
    arrays = bdpt.scene_arrays(cfg)
    verts = np.concatenate([v for v, _, _ in arrays["tris"]])
    mats = np.concatenate([np.full(len(v), m) for v, _, m in arrays["tris"]])
    prog = scenes.build_program_scene(arrays, "cpu")
    for k, f in enumerate(("tv0", "tv1", "tv2")):
        got = torch.stack(tuple(getattr(prog, f)), -1).numpy()
        assert np.array_equal(got, verts[:, k]), f
    assert np.array_equal(prog.tmat.numpy(), mats)
    ref = reference.RefScene(arrays, torch.device("cpu"))
    for k, f in enumerate(("v0", "v1", "v2")):
        assert np.array_equal(getattr(ref, f).numpy(), verts[:, k]), f
    assert np.array_equal(ref.tmat.numpy(), mats)
    assert prog.n_lights == ref.n_lights == 2
