"""A cell, a traffic mix and a per-layer metric defined by new files and
new entries alone: the harness finds them by name and runs the cell, and
no file of the benchmark changes."""
import json
import time
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_make_a_new_cell(tmp_path):
    here = tmp_path / "pb"
    for sub in ("traffic", "limits", "metrics", "configs"):
        (here / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench/configs/box_dense.json").read_text())
    cfg["name"] = "box_small_light"
    cfg["scene"]["materials"][3][1]["emission"] = [10.0, 10.0, 10.0]
    (here / "configs/box_small_light.json").write_text(json.dumps(cfg))
    (here / "traffic/peek_16.json").write_text(json.dumps(
        {"loop": "render", "width": 16, "height": 16, "spp_per_pass": 2,
         "samples_per_launch": 2, "warmup_passes": 1, "trace_units": 1,
         "check_pixels": 64}))
    (here / "limits/box_small_light.peek.json").write_text(
        json.dumps({"film_rel_l1": 0.01}))
    (here / "metrics/film_mean.peek.py").write_text(
        "def read(state, digest):\n"
        "    return float(state.film.mean())\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "box_small_light", "source": "a test", "reduced": [],
         "file": str(here / "configs/box_small_light.json"), "why": "a test"})
    bench["workloads"].append(
        {"name": "box_small_light.peek", "config": "box_small_light",
         "traffic": "peek_16", "chips": 1, "why": "a test"})
    bench["per_layer"].append(
        {"name": "film_mean.peek", "unit": "W", "better": "higher",
         "source": "program_counter", "layer": "entry",
         "moves": "mpaths_per_s", "workloads": ["box_small_light.peek"]})
    bench["end_to_end"][0]["workloads"].append("box_small_light.peek")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}

    cell = harness.resolve_cell(tmp_path, "box_small_light.peek", here=here)
    assert [m["name"] for m in cell.end_to_end] == ["mpaths_per_s",
                                                   "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["film_mean.peek"]
    line = harness.drive(cell, 17, 0.0, False, torch.device("cpu"),
                         time.perf_counter())
    assert line["correct"] and set(line["metrics"]) == {"mpaths_per_s",
                                                        "setup_s"}
    loop = harness.load_loop(cell)
    st = loop.setup(cell, 17, torch.device("cpu"))
    loop.unit(st)
    assert harness.load_reader("film_mean.peek", here)(st, None) > 0
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
