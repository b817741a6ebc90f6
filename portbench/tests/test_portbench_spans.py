"""The readers of the program's own spans (``portbench/spans.py`` and the
six metrics that use it), on tiny cells on the CPU, one traced unit under
a CPU profiler and a stub digest; and, ``gpu``-marked, the six in a traced
run's line on the card."""
import collections
import dataclasses
import json
import math
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.loops import invert, render
from tuturenderer_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2**31 + 77
NEW = {"box_dense.preview": ["intersect_host_ms.preview",
                             "shading_host_ms.preview",
                             "rng_host_ms.preview"],
       "box_dense.batch": ["live_lane_pct.batch"],
       "box_dense.invert": ["replay_recompute_ms.invert",
                            "first_step_s.invert"]}


def tiny(cell: str, **traffic):
    c = harness.resolve_cell(ROOT, cell)
    return dataclasses.replace(c, traffic=dict(c.traffic, **traffic))


@pytest.fixture
def fresh(monkeypatch):
    """A recorder of the test's own: the process's first calls are the
    test's."""
    monkeypatch.setattr(P, "RECORDER", P.Recorder())


def traced_units(loop, st, n=1):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(n):
            loop.unit(st)
    return types.SimpleNamespace(units=n)


def _render_cell(cell):
    c = tiny(cell, width=16, height=12, warmup_passes=1)
    return render.setup(c, SEED, CPU)


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_read_a_finite_value(fresh, cell):
    if cell == "box_dense.invert":
        st = invert.setup(tiny(cell, width=16, height=12, spp_per_step=2,
                               first_steps=1), SEED, CPU)
        dg = traced_units(invert, st)
    else:
        st = _render_cell(cell)
        dg = traced_units(render, st)
    for name in NEW[cell]:
        value = harness.load_reader(name)(st, dg)
        assert value is not None and math.isfinite(value) and value > 0, \
            name
    if cell == "box_dense.batch":
        assert harness.load_reader("live_lane_pct.batch")(st, dg) < 100


def test_readers_take_the_last_units_alone(fresh):
    st = _render_cell("box_dense.batch")
    dg = traced_units(render, st, 2)
    roots = [s for s in P.recorded() if s.name == "render"]
    assert len(roots) == 2 + 1            # the warm-up's first call, whole
    last = [s for s in P.recorded() if s.root == roots[-1].sid]
    near = [s for s in last if s.name == "isect.nearest"]
    want = 100.0 * sum(int(s.counts["live"]) for s in near) / \
        sum(s.counts["lanes"] for s in near)
    assert spans.traced(types.SimpleNamespace(units=1)) == last
    got = harness.load_reader("live_lane_pct.batch")(
        st, types.SimpleNamespace(units=1))
    assert got == pytest.approx(want)
    # self times: one unit's share of the two, each name's sum at most the
    # unit's duration, all of them exactly the root's
    by_name = spans.self_ns(last)
    assert sum(by_name.values()) == roots[-1].duration_ns
    two = spans.self_ms_per_unit(dg, lambda n: True)
    assert two == pytest.approx(
        (roots[-1].duration_ns + roots[-2].duration_ns) * 1e-6 / 2)
    assert spans.traced(types.SimpleNamespace(units=4)) is None


def test_program_counts_equal_traced_queries(fresh):
    """The live lanes the program counts in each query of the traced pass
    are those ``traced_queries`` counts by wrapping the queries, query for
    query, at the same sample ids."""
    st = _render_cell("box_dense.preview")
    dg = traced_units(render, st)
    st.info["window_first_sample"] = st.next_sample
    traced = spans.traced(dg)
    mine = collections.defaultdict(list)
    for s in traced:
        if s.name in ("isect.nearest", "isect.anyhit"):
            mine[s.name.split(".")[1]].append(int(s.counts["live"]))
    theirs = render.traced_queries(st, dg.units)
    assert mine == theirs and len(theirs["nearest"]) == 8


def test_without_the_recorder_readers_report_nothing(monkeypatch):
    """A program that records no spans (the parent of this benchmark's
    span readers) gives no value and raises nothing."""
    monkeypatch.setattr(spans, "recorder", lambda: None)
    dg = types.SimpleNamespace(units=1)
    for names in NEW.values():
        for name in names:
            assert harness.load_reader(name)(None, dg) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_line_on_the_card_holds_the_span_metrics(cuda, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4000000003", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"]
    for name in NEW[cell]:
        assert math.isfinite(line["metrics"][name]["value"]), name
