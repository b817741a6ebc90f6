"""What a run loads: neither JAX nor the JAX package, by whole top-level
names (the port's name begins with the JAX package's)."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

PROGRAM = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import dataclasses, torch
from pathlib import Path
from portbench import harness, tracing, calibrate, reference, roofline
from portbench.loops import render, invert
bench = harness.load_benchmark(Path({str(ROOT)!r}))
for m in bench["per_layer"]:
    harness.load_reader(m["name"])
for name, t in (("box_dense.preview", dict(width=8, height=8,
                                           check_pixels=64)),
                ("box_dense.invert", dict(width=8, height=8))):
    c = harness.resolve_cell(Path({str(ROOT)!r}), name)
    c = dataclasses.replace(c, traffic=dict(c.traffic, **t))
    assert harness.drive(c, 5, 0.0, False, torch.device("cpu"),
                         time.perf_counter()) is not None
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROGRAM], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.splitlines()[-2])
    assert "tuturenderer_tpu_torch" in tops
    for name in ("jax", "jaxlib", "flax", "tuturenderer_tpu"):
        assert name not in tops
    assert out.stdout.splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "tuturenderer_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "tuturenderer_tpu", raising=False)
    assert "tuturenderer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_without_a_card_a_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "box_dense.preview", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
