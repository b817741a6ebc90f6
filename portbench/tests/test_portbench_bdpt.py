"""The ``spd_tetra.bdpt`` cell on the CPU at tiny frames: the program's
BDPT against the plain reference (``portbench/reference_bdpt.py``) on the
SPD pyramid through the cluster tables, at SF 6 (16,388 triangles: past
the threshold) and at SF 2 with the threshold lowered; the control (the
reference in bfloat16), the half-batch fault and two faults planted in the
program's BDPT (its t = 1 splats dropped, every MIS weight 1) all failing
the cell's limit; a whole run through the harness; and the cell's four
readers, with and without the program's spans."""
import ast
import dataclasses
import math
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.loops import bdpt as loop
from tuturenderer_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 4099           # beyond 32 signed bits, as run seeds may be
CELL = "spd_tetra.bdpt"
TINY = dict(width=8, height=6, spp_per_pass=4, samples_per_launch=4,
            warmup_passes=0)
READERS = ("bvh_roofline.bdpt", "bdpt_connect_host_ms.bdpt",
           "connect_live_pct.bdpt", "table_build_s.bdpt")


def tiny(sf: int = 6, **traffic):
    c = harness.resolve_cell(ROOT, CELL)
    cfg = dict(c.config, scene=dict(c.config["scene"]))
    shapes = [dict(s) for s in cfg["scene"]["shapes"]]
    for s in shapes:
        if "spd_tetra" in s:
            s["spd_tetra"] = dict(s["spd_tetra"], size_factor=sf)
    cfg["scene"]["shapes"] = shapes
    traffic = dict(c.traffic, **dict(TINY, **traffic))
    return dataclasses.replace(c, config=cfg, traffic=traffic)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(P, "RECORDER", P.Recorder())


def one_pass(cell) -> loop.State:
    st = loop.setup(cell, SEED, CPU)
    loop.unit(st)
    return st


@pytest.mark.parametrize("sf,forced", [(6, False), (2, True)])
def test_program_film_matches_reference(monkeypatch, sf, forced):
    if forced:
        from tuturenderer_tpu_torch.scene import data
        monkeypatch.setattr(data, "BVH_THRESHOLD", 0)
    c = tiny(sf)
    st = one_pass(c)
    assert st.info["n_tris"] == 4 ** (sf + 1) + 4
    assert st.scene.clusters is not None
    assert st.first_image.min() >= 0 and st.first_image.mean() > 0.05
    got = loop.check(st)["film_rel_l1"]
    assert got <= c.limits["film_rel_l1"], got


@pytest.mark.parametrize("stand_in", ["control", "half"])
def test_control_and_half_batch_fail(stand_in):
    c = tiny()
    st = one_pass(c)
    got = loop.check(st, **{stand_in: True})["film_rel_l1"]
    assert got > c.limits["film_rel_l1"], got


def dropped_splats(monkeypatch):
    from tuturenderer_tpu_torch.integrators import bdpt
    monkeypatch.setattr(bdpt, "splat_film", lambda film, idx, rgb: film)


def mis_weight_one(monkeypatch):
    from tuturenderer_tpu_torch.integrators import bdpt
    monkeypatch.setattr(bdpt, "mis_weight",
                        lambda scene, cam, ep, *a, **k:
                        torch.ones_like(ep[0]["valid"], dtype=torch.float32))


@pytest.mark.parametrize("fault", [dropped_splats, mis_weight_one])
def test_planted_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    c = tiny()
    got = loop.check(one_pass(c))["film_rel_l1"]
    assert got > c.limits["film_rel_l1"], got


@pytest.mark.parametrize("fault", [None, dropped_splats])
def test_whole_run_through_the_harness(monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    c = tiny(2, warmup_passes=1)
    line = harness.drive(c, SEED, 0.0, False, CPU, time.perf_counter())
    assert line["correct"] == (fault is None)
    assert set(line["metrics"]) == {"mpaths_per_s", "setup_s"}
    assert line["attempted"] == 1 and line["failed"] == 0


def test_readers_read_the_programs_spans(fresh):
    c = tiny()
    st = loop.setup(c, SEED, CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        loop.unit(st)
    traced = spans.traced(types.SimpleNamespace(units=1))
    near = [s for s in traced if s.name == "isect.nearest"]
    shadow = [s for s in traced if s.name == "isect.anyhit"]
    assert (len(near), len(shadow)) == (13, 1)
    # the device's records stood in for: one K5 and one K6 record a query
    dg = types.SimpleNamespace(units=1, complete=True, kernels={
        "bvh_walk_kernel<0>": (13, 0.013), "bvh_walk_kernel<1>": (1, 0.002)})
    got = {name: harness.load_reader(name)(st, dg) for name in READERS}
    assert all(v is not None and math.isfinite(v) and v > 0
               for v in got.values()), got
    assert got["connect_live_pct.bdpt"] < 100
    assert got["table_build_s.bdpt"] <= st.info["table_build_s"]
    conn = [s for s in traced if s.name == "bdpt.connect"]
    assert got["connect_live_pct.bdpt"] == pytest.approx(
        100 * int(conn[0].counts["live"]) / conn[0].counts["rays"])
    # one K5 record fewer than the queries: no share
    dg.kernels["bvh_walk_kernel<0>"] = (12, 0.013)
    assert harness.load_reader("bvh_roofline.bdpt")(st, dg) is None


def test_without_the_spans_readers_report_nothing(monkeypatch):
    """A program without BDPT's spans (the parent of this cell) gives no
    value and raises nothing."""
    monkeypatch.setattr(spans, "recorder", lambda: None)
    dg = types.SimpleNamespace(units=1, complete=True, kernels={
        "bvh_walk_kernel<0>": (13, 0.013), "bvh_walk_kernel<1>": (1, 0.002)})
    st = types.SimpleNamespace(info={"table_build_s": 1.0, "n_tris": 68})
    for name in READERS:
        assert harness.load_reader(name)(st, dg) is None, name


def test_reference_and_generator_import_nothing_of_the_program():
    for name in ("reference_bdpt.py", "spd.py"):
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
