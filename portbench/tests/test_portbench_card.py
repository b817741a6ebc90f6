"""A short run of each cell on the card (``gpu``-marked; skips without
one): ``python3 -m pytest portbench/tests -m gpu``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["box_dense.preview", "box_dense.invert", "box_dense.batch"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4000000001", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
