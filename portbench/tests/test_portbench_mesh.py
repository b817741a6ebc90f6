"""The ``spd_tetra9.path`` cell on the CPU at tiny frames: a ``render_mesh``
cell resolved and run from new files alone; the program's path tracer on
the SPD pyramid at SF 5 (4,100 triangles, through the cluster tables)
against the plain reference, and the control (the reference in bfloat16)
and the half-batch fault failing the cell's limit; the cell's five
readers, on stand-in records where the CPU has none, and with nothing to
read on a program without the walk counters; and, ``gpu``-marked, the
five in a traced run's line on the card."""
import dataclasses
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.loops import render_mesh as loop
from tuturenderer_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 8191           # beyond 32 signed bits, as run seeds may be
CELL = "spd_tetra9.path"
TINY = dict(width=12, height=10, spp_per_pass=2, samples_per_launch=2,
            warmup_passes=0, check_pixels=120)
READERS = ("bvh_roofline.mesh", "walk_device_ms.mesh",
           "walk_visits_per_ray.mesh", "table_build_s.mesh",
           "graph_replay_pct.mesh")
WALKS = {"bvh_walk_kernel<0>": (16, 0.016), "bvh_walk_kernel<1>": (14, 0.01)}


def sf_config(cfg: dict, sf: int) -> dict:
    cfg = dict(cfg, scene=dict(cfg["scene"]))
    cfg["scene"]["shapes"] = [
        dict(s, spd_tetra=dict(s["spd_tetra"], size_factor=sf))
        if "spd_tetra" in s else s for s in cfg["scene"]["shapes"]]
    return cfg


def tiny(sf: int = 5, **traffic):
    c = harness.resolve_cell(ROOT, CELL)
    return dataclasses.replace(c, config=sf_config(c.config, sf),
                               traffic=dict(c.traffic, **dict(TINY,
                                                              **traffic)))


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(P, "RECORDER", P.Recorder())


def test_new_files_make_a_render_mesh_cell(tmp_path):
    here = tmp_path / "pb"
    for sub in ("traffic", "limits", "metrics", "configs"):
        (here / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench/configs/spd_tetra9.json")
                     .read_text())
    cfg = dict(sf_config(cfg, 5), name="spd_tetra5")
    (here / "configs/spd_tetra5.json").write_text(json.dumps(cfg))
    (here / "traffic/mesh_peek.json").write_text(json.dumps(
        dict(TINY, loop="render_mesh", warmup_passes=1, trace_units=1)))
    (here / "limits/spd_tetra5.peek.json").write_text(
        (ROOT / "portbench/limits/spd_tetra9.path.json").read_text())
    (here / "metrics/n_tris.peek.py").write_text(
        "def read(state, digest):\n"
        "    return state.info['n_tris']\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "spd_tetra5", "source": "a test", "reduced": [],
         "file": str(here / "configs/spd_tetra5.json"), "why": "a test"})
    bench["workloads"].append(
        {"name": "spd_tetra5.peek", "config": "spd_tetra5",
         "traffic": "mesh_peek", "chips": 1, "why": "a test"})
    bench["per_layer"].append(
        {"name": "n_tris.peek", "unit": "triangles", "better": "higher",
         "source": "program_counter", "layer": "tables",
         "moves": "mpaths_per_s", "workloads": ["spd_tetra5.peek"]})
    bench["end_to_end"][0]["workloads"].append("spd_tetra5.peek")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}

    cell = harness.resolve_cell(tmp_path, "spd_tetra5.peek", here=here)
    assert harness.load_loop(cell) is loop
    assert [m["name"] for m in cell.end_to_end] == ["mpaths_per_s",
                                                   "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["n_tris.peek"]
    line = harness.drive(cell, SEED, 0.0, False, CPU, time.perf_counter())
    assert line["correct"] and set(line["metrics"]) == {"mpaths_per_s",
                                                        "setup_s"}
    assert line["attempted"] == 1 and line["failed"] == 0
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


@pytest.mark.parametrize("stand_in", ["program", "control", "half"])
def test_program_passes_and_control_and_half_batch_fail(stand_in):
    c = tiny()
    st = loop.setup(c, SEED, CPU)
    assert st.scene.clusters is not None and st.info["n_tris"] == 4100
    for _ in range(2):
        loop.unit(st)
    if stand_in == "program":
        got = loop.check(st)["film_rel_l1"]
        assert got <= c.limits["film_rel_l1"], got
    else:
        got = loop.check(st, **{stand_in: True})["film_rel_l1"]
        assert got > c.limits["film_rel_l1"], got


def test_readers_read_the_programs_spans(fresh):
    c = tiny()
    st = loop.setup(c, SEED, CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        loop.unit(st)
    traced = spans.traced(types.SimpleNamespace(units=1))
    near = [s for s in traced if s.name == "isect.nearest"]
    shadow = [s for s in traced if s.name == "isect.anyhit"]
    assert (len(near), len(shadow)) == (8, 7)
    # the device's records stood in for: one K5 or K6 record a query
    dg = types.SimpleNamespace(units=1, complete=True, kernels={
        "bvh_walk_kernel<0>": (8, 0.008), "bvh_walk_kernel<1>": (7, 0.005)})
    got = {name: harness.load_reader(name)(st, dg) for name in READERS}
    # off the card the plain versions visit no node: no visits to read
    assert got.pop("walk_visits_per_ray.mesh") is None
    assert all(v is not None and math.isfinite(v) and v >= 0
               for v in got.values()), got
    assert got["walk_device_ms.mesh"] == pytest.approx(13.0)
    assert 0 < got["table_build_s.mesh"] <= st.info["table_build_s"]
    assert 0 < got["bvh_roofline.mesh"] < 100
    # one K5 record fewer than the queries: no share
    dg.kernels["bvh_walk_kernel<0>"] = (7, 0.008)
    assert harness.load_reader("bvh_roofline.mesh")(st, dg) is None


def test_visits_per_ray_is_visits_over_live_lanes(monkeypatch):
    rec = lambda name, **counts: types.SimpleNamespace(name=name,
                                                       counts=counts)
    traced = [rec("isect.nearest", lanes=8, live=8,
                  visits=torch.tensor(160), tests=torch.tensor(40)),
              rec("isect.anyhit", lanes=8, live=2,
                  visits=torch.tensor(26), tests=torch.tensor(5)),
              rec("isect.transmit", lanes=8, live=4, visits=torch.tensor(34)),
              rec("isect.nearest", lanes=4, live=4),      # a dense query
              rec("shade.hit")]
    monkeypatch.setattr(spans, "traced", lambda digest: traced)
    read = harness.load_reader("walk_visits_per_ray.mesh")
    assert read(None, types.SimpleNamespace(units=1)) == \
        pytest.approx((160 + 26 + 34) / (8 + 2 + 4))


def test_without_the_counters_readers_report_nothing(monkeypatch):
    """The parent program of this cell: spans but no walk counts, no
    recorder at all, or an incomplete trace; no value, and nothing
    raised."""
    st = types.SimpleNamespace(info={"table_build_s": 1.0, "n_tris": 4100})
    dg = types.SimpleNamespace(units=1, complete=True, kernels=dict(WALKS))
    monkeypatch.setattr(spans, "traced", lambda digest: [
        types.SimpleNamespace(name="isect.nearest",
                              counts={"lanes": 8, "live": 8})])
    assert harness.load_reader("walk_visits_per_ray.mesh")(st, dg) is None
    assert harness.load_reader("table_build_s.mesh")(st, dg) is None
    monkeypatch.setattr(spans, "recorder", lambda: None)
    monkeypatch.setattr(spans, "traced", lambda digest: None)
    for name in ("bvh_roofline.mesh", "walk_visits_per_ray.mesh"):
        assert harness.load_reader(name)(st, dg) is None, name
    dg.complete = False
    assert harness.load_reader("walk_device_ms.mesh")(st, dg) is None


@pytest.mark.gpu
def test_traced_line_on_the_card_holds_the_five_readers(cuda):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "4000000007", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"]
    for name in READERS:
        assert math.isfinite(line["metrics"][name]["value"]), name
