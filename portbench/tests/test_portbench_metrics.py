"""The arithmetic of the metrics: the window rate, the percentile with its
sample count, the spread, the reduction of a trace, and the roofline's
bytes, which do not depend on how the program finds its hits."""
import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, roofline, scenes, stats, tracing
ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def test_rate_is_all_work_over_all_time():
    assert stats.rate(1_048_576 * 30, 10.0) == pytest.approx(3145728.0)


def test_percentile_and_its_sample_count():
    xs = list(np.random.default_rng(0).permutation(np.arange(1.0, 101.0)))
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))
    assert stats.beyond(xs, 90) == 10
    assert stats.percentile([5.0], 90) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


class Ev:
    def __init__(self, name, start, end, device=False):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def test_digest_of_a_trace():
    ev = [Ev("aten::mul", 0, 40), Ev("aten::nonzero", 20, 30),
          Ev("cudaLaunchKernel", 1, 2), Ev("cudaLaunchKernel", 5, 6),
          Ev("cudaGraphLaunch", 7, 8), Ev("_RenderDiffBackward", 10, 20),
          Ev("autograd::engine::evaluate_function: _RenderDiffBackward",
             9, 21),
          Ev("woop_nearest_kernel(float const*)", 0, 10, True),
          Ev("elementwise", 5, 15, True), Ev("woop_anyhit_kernel", 32, 36,
                                             True)]
    d = tracing.digest_events(ev, 0, 40, ("_RenderDiffBackward",))
    assert d["busy_s"] == pytest.approx(19e-9)
    assert d["host_launches"] == 3
    assert d["kernels"]["woop_nearest_kernel"] == (1, pytest.approx(1e-8))
    assert d["kernels"]["woop_anyhit_kernel"] == (1, pytest.approx(4e-9))
    assert d["host_spans"]["_RenderDiffBackward"] == pytest.approx(12e-9)
    gaps = dict(d["breakdown"]["idle_gaps"])
    # the gap 15-32 has its middle in aten::nonzero, inside aten::mul;
    # the gap 36-40 in aten::mul alone
    assert gaps["aten::nonzero"] == pytest.approx(17e-9)
    assert gaps["aten::mul"] == pytest.approx(4e-9)


def test_roofline_bytes_count_live_rays_and_triangles_only():
    assert roofline.nearest_bytes(1_048_576, 12) == 1_048_576 * 40 + 12 * 36
    assert roofline.anyhit_bytes(1_048_576, 12) == 1_048_576 * 29 + 12 * 36
    kernels = {"woop_nearest_kernel": (3, 3 * 40e-6),
               "woop_anyhit_kernel": (2, 2 * 40e-6)}
    dg = types.SimpleNamespace(complete=True, kernels=kernels)
    q = {"nearest": [1_048_576, 600_000, 200_000],
         "anyhit": [500_000, 150_000]}
    pct = roofline.roofline_pct(dg, q, 12, "woop_nearest_kernel",
                                "woop_anyhit_kernel")
    least = (roofline.nearest_bytes(1_048_576, 12) +
             roofline.nearest_bytes(600_000, 12) +
             roofline.nearest_bytes(200_000, 12) +
             roofline.anyhit_bytes(500_000, 12) +
             roofline.anyhit_bytes(150_000, 12)) / 3.35e12
    assert pct == pytest.approx(100 * least / (5 * 40e-6))
    assert roofline.roofline_pct(dg, lambda: q, 12, "woop_nearest_kernel",
                                 "woop_anyhit_kernel") == pct
    # another number of launches than the trace holds: no reading
    short = {"nearest": q["nearest"][:2], "anyhit": q["anyhit"]}
    assert roofline.roofline_pct(dg, short, 12, "woop_nearest_kernel",
                                 "woop_anyhit_kernel") is None
    dg.complete = False
    assert roofline.roofline_pct(dg, q, 1, "woop_nearest_kernel",
                                 "woop_anyhit_kernel") is None


@pytest.mark.parametrize("cell", ["woop_roofline.preview",
                                  "woop_roofline.batch"])
def test_roofline_unchanged_under_another_tree(cell):
    """The same rays and triangles read the same share whether the
    program holds the scene densely or under its cluster tables and BVH."""
    cfg = scenes.load_json(ROOT / "portbench/configs/box_dense.json")
    arrays = scenes.scene_arrays(cfg)
    dense = scenes.build_program_scene(arrays, CPU)
    read = harness.load_reader(cell)
    dg = types.SimpleNamespace(complete=True, units=1, kernels={
        "woop_nearest_kernel": (2, 3e-4), "woop_anyhit_kernel": (1, 3e-4)})
    q = {"nearest": [1_048_576, 700_000], "anyhit": [650_000]}
    got = []
    for scene in (dense, _with_tables(arrays)):
        assert (scene.clusters is None) == (scene is dense)
        st = types.SimpleNamespace(scene=scene, info={
            "n_tris": scenes.n_triangles(arrays), "traced_queries": q})
        got.append(read(st, dg))
    assert got[0] == got[1] is not None


def test_traced_queries_count_live_lanes_of_the_traced_passes():
    """The replay of the traced passes counts every lane of the camera
    rays' query and only the live lanes of later ones, and leaves the film
    and the sample ids as they were."""
    from portbench.loops import render
    c = harness.resolve_cell(ROOT, "box_dense.preview")
    c = dataclasses.replace(c, traffic=dict(c.traffic, width=16, height=12,
                                            warmup_passes=1))
    st = render.setup(c, 2**31 + 5, CPU)
    render.unit(st)                               # the "traced" pass
    st.info["window_first_sample"] = st.next_sample
    film, nxt = st.film.copy(), st.next_sample
    q = render.traced_queries(st, 1)
    lanes = 16 * 12
    assert q["nearest"][0] == lanes
    assert all(0 <= n <= lanes for n in q["nearest"] + q["anyhit"])
    assert min(q["nearest"]) < lanes and q["anyhit"]
    assert len(q["nearest"]) == c.config["integrator"]["max_depth"] + 2
    assert np.array_equal(st.film, film) and st.next_sample == nxt
    assert render.traced_queries(st, 1) is q


def _with_tables(arrays):
    from tuturenderer_tpu_torch.scene.data import SceneBuilder
    b = SceneBuilder(bkgcolor=tuple(arrays["bkgcolor"].tolist()))
    for m in arrays["materials"]:
        b.add_material(m["mtype"], diffuse=m["diffuse"],
                       emission=m["emission"], eta=m["eta"])
    for v, n, mat in arrays["tris"]:
        b.add_triangles(v, n, None, mat)
    return b.build(use_bvh=True, device=CPU)
