"""The path tracer on a mesh through the cluster route, on the CPU: the
SPD tetra at SF 5 (4,096 + 4 triangles, at the cluster-table threshold)
rendered by ``integrators/path.py::render`` at a tiny frame and held
against the benchmark's plain reference (``portbench/reference.py``) by
``film_rel_l1`` at the ``spd_tetra9.path`` cell's limit; two faults
planted in the cluster queries fail it; the cell's configuration is the
SF 9 pyramid, the ground and the light; and off the card a query's span
carries no walk counts, since the plain versions visit no node."""
import dataclasses
from pathlib import Path

import pytest
import torch

import torch_port_util  # noqa: F401  (one intra-op thread a process)
from portbench import harness, spd
from portbench.loops import render_mesh
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.scene import data
from tuturenderer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 2207           # beyond 32 signed bits, as run seeds may be
CELL = "spd_tetra9.path"


def tiny(sf: int = 5):
    c = harness.resolve_cell(ROOT, CELL)
    cfg = dict(c.config, scene=dict(c.config["scene"]))
    cfg["scene"]["shapes"] = [
        dict(s, spd_tetra=dict(s["spd_tetra"], size_factor=sf))
        if "spd_tetra" in s else s for s in cfg["scene"]["shapes"]]
    traffic = dict(c.traffic, width=12, height=10, spp_per_pass=2,
                   samples_per_launch=2, warmup_passes=0, check_pixels=120)
    return dataclasses.replace(c, config=cfg, traffic=traffic)


def two_passes(cell):
    st = render_mesh.setup(cell, SEED, CPU)
    for _ in range(2):
        render_mesh.unit(st)
    return st


def test_path_render_on_the_cluster_route_matches_reference(monkeypatch):
    calls = {"nearest": 0, "anyhit": 0}

    def counted(kind, real):
        def call(*args, **kw):
            calls[kind] += 1
            return real(*args, **kw)
        return call
    monkeypatch.setattr(TI, "cluster_intersect",
                        counted("nearest", TI.cluster_intersect))
    monkeypatch.setattr(TI, "cluster_occluded",
                        counted("anyhit", TI.cluster_occluded))
    c = tiny()
    st = two_passes(c)
    assert st.info["n_tris"] == 4 ** 6 + 4 >= data.BVH_THRESHOLD
    assert st.scene.clusters is not None
    # two passes of one wavefront: max_depth + 2 nearest hits and
    # max_depth + 1 shadow queries each, every one a cluster query
    assert calls == {"nearest": 2 * 8, "anyhit": 2 * 7}
    assert st.film.min() >= 0 and st.film.mean() > 0.05
    got = render_mesh.check(st)["film_rel_l1"]
    assert got <= c.limits["film_rel_l1"], got


def dropped_blockers(monkeypatch):
    monkeypatch.setattr(TI, "cluster_occluded",
                        lambda clusters, ox, *a, **k: torch.zeros_like(
                            ox, dtype=torch.bool))


def wrong_triangle_ids(monkeypatch):
    real = TI.cluster_intersect

    def shifted(clusters, *args, **kw):
        t, idx, bu, bv = real(clusters, *args, **kw)
        n = int(clusters.tri_idx.max()) + 1
        return t, torch.where(idx >= 0, (idx + 1) % n, idx), bu, bv
    monkeypatch.setattr(TI, "cluster_intersect", shifted)


@pytest.mark.parametrize("fault", [dropped_blockers, wrong_triangle_ids])
def test_planted_faults_fail_the_limit(monkeypatch, fault):
    fault(monkeypatch)
    c = tiny()
    got = render_mesh.check(two_passes(c))["film_rel_l1"]
    assert got > c.limits["film_rel_l1"], got


def test_config_is_the_sf9_pyramid_ground_and_light(monkeypatch):
    c = harness.resolve_cell(ROOT, CELL)
    assert c.config["integrator"] == {"name": "path", "max_depth": 6,
                                      "min_depth": 3, "mis": True,
                                      "russian_roulette": True}
    handed = {}

    class Built(Exception):
        pass

    def build(arrays, device):
        handed["arrays"] = arrays
        raise Built
    monkeypatch.setattr(render_mesh.scenes, "build_program_scene", build)
    with pytest.raises(Built):
        render_mesh.setup(c, SEED, CPU)
    arrays = handed["arrays"]
    counts = [v.shape[0] for v, _, _ in arrays["tris"]]
    assert sorted(counts) == [2, 2, 4 ** 10]
    assert sum(counts) == 1_048_580
    mats = arrays["materials"]
    names = [n for n, _ in c.config["scene"]["materials"]]
    pyramid = [v for v, _, m in arrays["tris"] if v.shape[0] == 4 ** 10][0]
    shape = [s for s in c.config["scene"]["shapes"] if "spd_tetra" in s][0]
    assert shape["spd_tetra"]["size_factor"] == 9
    assert torch.equal(torch.from_numpy(pyramid), torch.from_numpy(
        spd.tetra_triangles(shape["spd_tetra"])))
    rough = mats[names.index("pyramid")]
    assert (rough["mtype"], rough["roughness"], rough["metallic"]) == \
        (3, 0.2775146484375, 0.5)
    emissive = [n for n, m in zip(names, mats) if any(m["emission"])]
    assert emissive == ["light"]


def test_cpu_query_spans_carry_no_walk_counts(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    st = render_mesh.setup(tiny(), SEED, CPU)
    with profiling.recording():
        render_mesh.unit(st)
    queries = [s for s in profiling.recorded()
               if s.name in ("isect.nearest", "isect.anyhit")]
    assert len(queries) == 8 + 7
    assert all("live" in s.counts and "visits" not in s.counts and
               "tests" not in s.counts for s in queries)
