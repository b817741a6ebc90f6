"""The program against the plain reference, on the CPU at tiny frames:
the scenes the benchmark makes are the presets', the program's film and
the reference's agree, and the control (the reference in bfloat16 in the
program's place) fails the cell's limit."""
import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import harness, reference, scenes
from portbench.loops import invert, render

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 12345          # beyond 32 signed bits, as run seeds may be
MESH = Path(__file__).resolve().parent / "mesh_scene.json"


def tiny(cell: str, **traffic):
    c = harness.resolve_cell(ROOT, cell)
    return dataclasses.replace(c, traffic=dict(c.traffic, **traffic))


def test_box_dense_is_simple_box():
    from tuturenderer_tpu_torch.scene.presets import simple_box
    cfg = scenes.load_json(ROOT / "portbench/configs/box_dense.json")
    ours = scenes.build_program_scene(scenes.scene_arrays(cfg), CPU)
    theirs, cam = simple_box(16, 12, device=CPU)
    for f in ("tv0", "tv1", "tv2", "tn0", "tn1", "tn2", "scenter"):
        for a, b in zip(getattr(ours, f), getattr(theirs, f)):
            assert torch.equal(a, b), f
    for f in ("tmat", "smat", "sradius", "light_idx"):
        assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
    for f in ("diffuse", "emission"):
        for a, b in zip(getattr(ours.materials, f),
                        getattr(theirs.materials, f)):
            assert torch.equal(a, b), f
    mine = scenes.program_camera(cfg["camera"], 16, 12, CPU)
    for f in ("position", "ul", "delta_h", "delta_v", "c_off"):
        for a, b in zip(getattr(mine, f), getattr(cam, f)):
            assert torch.equal(a, b), f


@pytest.mark.parametrize("cell,traffic", [
    ("box_dense.preview", dict(width=24, height=24, check_pixels=576)),
    ("box_dense.batch", dict(width=20, height=16, spp_per_pass=2,
                             samples_per_launch=2, check_pixels=320)),
])
def test_render_film_matches_reference(cell, traffic):
    c = tiny(cell, **traffic)
    st = render.setup(c, SEED, CPU)
    for _ in range(2):
        render.unit(st)
    got = render.check(st)["film_rel_l1"]
    assert got <= c.limits["film_rel_l1"]


def test_mesh_film_matches_reference():
    """A small mesh scene (under the cluster-table threshold the program
    tests it densely; the reference walks its own tree above 64
    triangles), in the place of the batch cell's scene."""
    c = tiny("box_dense.batch", width=12, height=12, spp_per_pass=2,
             samples_per_launch=2, check_pixels=144)
    c = dataclasses.replace(c, config=scenes.load_json(MESH))
    st = render.setup(c, SEED, CPU)
    render.unit(st)
    assert render.check(st)["film_rel_l1"] <= c.limits["film_rel_l1"]


@pytest.mark.parametrize("stand_in", ["control", "half"])
def test_render_control_and_half_batch_fail(stand_in):
    """The control, and the reference over half of the samples in the
    program's place, both fail the preview's limit."""
    c = tiny("box_dense.preview", width=24, height=24, check_pixels=576)
    st = render.setup(c, SEED, CPU)
    for _ in range(2):
        render.unit(st)
    got = render.check(st, **{stand_in: True})["film_rel_l1"]
    assert got > c.limits["film_rel_l1"]


def test_invert_matches_reference_and_control_fails():
    c = tiny("box_dense.invert", width=64, height=64)
    st = invert.setup(c, SEED, CPU)
    got = invert.check(st)
    assert all(got[k] <= c.limits[k] for k in got), got
    st = invert.setup(c, SEED, CPU)
    ctrl = invert.check(st, control=True)
    assert not all(ctrl[k] <= c.limits[k] for k in ctrl), ctrl


def test_reference_tree_equals_brute_force():
    """The reference's own tree finds the hits that testing every
    triangle finds."""
    cfg = scenes.load_json(MESH)
    sph = cfg["scene"]["shapes"][0]["uv_sphere"]
    sph["nu"] = sph["nv"] = 16
    arrays = scenes.scene_arrays(cfg)
    ref = reference.RefScene(arrays, CPU)
    assert ref.tree is not None
    g = torch.Generator().manual_seed(3)
    o = torch.rand((512, 3), generator=g) * 4 - 2
    d = reference.normalize(torch.randn((512, 3), generator=g))
    hit = ref.nearest(o, d)
    t, u, v, ok = ref._tri_test(o[:, None], d[:, None], ref.v0[None],
                                ref.v1[None], ref.v2[None], ref.ng[None])
    brute = torch.where(ok, t, reference.BIG).min(1).values
    assert torch.equal(hit["t"], brute)
    dist = torch.full((512,), 1.5)
    blocked = ((ok & (t < 1.5) & ((t - 1.5).abs() >= 1e-4)).any(1))
    assert torch.equal(ref.occluded(o, d, dist), blocked)


def test_reference_imports_nothing_of_the_program():
    import ast
    for name in ("reference.py", "ref_rng.py"):
        tree = ast.parse((ROOT / "portbench" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "tuturenderer_tpu_torch", "tuturenderer_tpu", "jax"), m
