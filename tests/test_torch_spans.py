"""The span recorder of ``tuturenderer_tpu_torch/utils/profiling.py`` and
the spans and counters at the port's layer boundaries, on a 16x12
``simple_box`` on the CPU:

- the tree of one ``render`` under ``recording()``: its names, one
  ``bounce`` a depth, the nesting, and self times that add up to the
  root's duration;
- off (no ``recording()``, no profiler): nothing recorded, no span made,
  every ``with`` site handed the one ``OFF``;
- films and gradients bit-equal with recording on and off;
- under ``torch.profiler``, every span a host event of the same name
  within its ``time.time_ns()`` bracket (one clock for both);
- under ``image_loss_and_grad``, the recomputed bounces inside
  ``replay.grad``; a span opened on a thread with nothing open takes the
  span open on the thread that waits for it;
- the ``isect.nearest`` live-lane counts against
  ``trace_rays(collect_alive=True)``, bounce for bounce;
- the first call of a unit recorded whole, and the buffer bounded;
- BDPT: a render its own ``render`` root, with ``bdpt.eye`` (7 nearest
  queries), ``bdpt.light`` (6), ``bdpt.connect`` (``rays`` 27 N at length
  7, ``live`` at most that and equal to its shadow query's) and
  ``bdpt.splat`` (``splats`` equal to the splats that land on the film) a
  wavefront, and its film bit-equal with recording on and off;
- a scene build that makes cluster tables records ``tables.build``
  (``triangles``, non-empty ``clusters``), a dense one does not, and
  nothing of either is recorded while the recorder is off;
- ``paused()`` (a CUDA graph's capture) records nothing inside a
  recording and restores it after; ``recording_on()`` says where spans
  record; a BDPT render on the CPU captures no graph, and the tensors a
  capture keeps (``cuda_graph.leaves``) are every tensor of the scene and the
  camera.
"""
import collections
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one intra-op thread a process)
from tuturenderer_tpu_torch import grad
from tuturenderer_tpu_torch.camera import primary_ray
from tuturenderer_tpu_torch.integrators import bdpt, path
from tuturenderer_tpu_torch.integrators.light import splat_film
from tuturenderer_tpu_torch.ops.cluster import build_clusters
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.data import SceneBuilder
from tuturenderer_tpu_torch.scene.presets import simple_box
from tuturenderer_tpu_torch.utils import cuda_graph
from tuturenderer_tpu_torch.utils import profiling as P

OPTS = RenderOptions(spp=2, max_depth=6, min_depth=3)
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def box():
    return simple_box(16, 12, device="cpu")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder for the test, its units' first calls spent."""
    r = P.Recorder()
    r._seen.update({"render", "step"})
    monkeypatch.setattr(P, "RECORDER", r)
    return r


def _recorded_render(box, opts=OPTS):
    scene, cam = box
    with P.recording():
        img = path.render(scene, cam, opts, SEED)
    return img, P.recorded()


def _children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def _ancestors(s, by_sid):
    out = []
    while s.parent is not None:
        s = by_sid[s.parent]
        out.append(s.name)
    return out


def self_ns(spans):
    """Each span's duration less those of the spans it holds."""
    inner = collections.Counter()
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.duration_ns
    return {s.sid: s.duration_ns - inner[s.sid] for s in spans}


def test_render_span_tree(box, rec):
    _, spans = _recorded_render(box)
    by_sid = {s.sid: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["render"]
    root = roots[0]
    assert all(s.root == root.sid for s in spans)
    names = collections.Counter(s.name for s in spans)
    assert set(names) == {"render", "render.sample", "bounce",
                          "bounce.epilogue", "isect.nearest", "isect.anyhit",
                          "shade.hit", "shade.material", "shade.light",
                          "shade.bsdf", "rng"}
    samples = [s for s in spans if s.name == "render.sample"]
    assert len(samples) == OPTS.spp
    kids = _children(spans)
    for smp in samples:
        assert smp.parent == root.sid
        bounces = [c for c in kids[smp.sid] if c.name == "bounce"]
        assert [b.counts["depth"] for b in bounces] == \
            list(range(OPTS.max_depth + 1))
        for b in bounces:
            inner = collections.Counter(c.name for c in kids[b.sid])
            assert inner["isect.nearest"] == inner["isect.anyhit"] == 1
            assert inner["shade.hit"] == 1 and inner["rng"] == 7
        epi = [c for c in kids[smp.sid] if c.name == "bounce.epilogue"]
        assert len(epi) == 1
        assert [c.name for c in kids[epi[0].sid]].count("isect.nearest") == 1
    # every query sits in a bounce or the epilogue; every span inside its
    # parent's interval
    for s in spans:
        if s.name.startswith("isect."):
            assert by_sid[s.parent].name in ("bounce", "bounce.epilogue")
        if s.parent is not None:
            p = by_sid[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert sum(self_ns(spans).values()) == root.duration_ns
    assert all(v >= 0 for v in self_ns(spans).values())


def test_off_records_nothing_and_hands_back_one_object(box, rec,
                                                       monkeypatch):
    scene, cam = box
    _, on = _recorded_render(box)
    rec.spans.clear()
    assert P.span("bounce") is P.OFF and P.unit("render") is P.OFF
    entered = []

    def enter(self):
        entered.append(self)
        return self

    def no_span(*a, **k):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(P._Off, "__enter__", enter)
    monkeypatch.setattr(P._Span, "__init__", no_span)
    path.render(scene, cam, OPTS, SEED)
    assert P.recorded() == []
    assert entered and all(e is P.OFF for e in entered)
    # the with-sites (the decorated ones call straight through); the BSDF's
    # evaluation, sampling and pdf are with-sites that count ``kernel``
    with_sites = ("render", "render.sample", "bounce", "isect.nearest",
                  "isect.anyhit", "rng")
    assert len(entered) == sum(s.name in with_sites or (
        s.name == "shade.bsdf" and "kernel" in s.counts) for s in on)


def test_film_and_gradient_bit_equal_on_and_off(box, rec):
    scene, cam = box
    img_on, _ = _recorded_render(box)
    img_off = path.render(scene, cam, OPTS, SEED)
    assert torch.equal(img_on, img_off)
    params = grad.get_params(scene)
    target = torch.full((12, 16, 3), 0.25)
    opts = RenderOptions(spp=2, samples_per_launch=2)
    got = []
    for on in (True, False):
        with P.recording() if on else contextlib.nullcontext():
            loss, g = grad.image_loss_and_grad(params, target, scene, cam,
                                               opts, SEED)
        got.append((loss, g.leaves()))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


def test_spans_on_the_profilers_clock(box, rec):
    from torch.profiler import ProfilerActivity, profile
    scene, cam = box
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path.render(scene, cam, OPTS, SEED)
    spans = P.recorded()
    assert spans and spans[-1].name == "render"
    names = {s.name for s in spans}
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events[e.name()].append((e.start_ns(), e.end_ns()))
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert a <= c <= d <= b, name


def test_recomputed_bounces_inside_replay_grad(box, rec):
    scene, cam = box
    opts = RenderOptions(spp=4, samples_per_launch=2)
    with P.recording():
        grad.image_loss_and_grad(grad.get_params(scene),
                                 torch.zeros((12, 16, 3)), scene, cam, opts,
                                 SEED)
    spans = P.recorded()
    by_sid = {s.sid: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["step"]
    assert all(s.root == roots[0].sid for s in spans)
    where = collections.Counter()
    for s in spans:
        if s.name == "bounce":
            up = _ancestors(s, by_sid)
            where[next(a for a in up if a.startswith("replay."))] += 1
    per = opts.max_depth + 1
    batches = opts.spp // opts.samples_per_launch
    assert where == {"replay.forward": per * batches,
                     "replay.batch": per * batches,
                     "replay.grad": per * batches}
    grads = [s for s in spans if s.name == "replay.grad"]
    assert len(grads) == batches
    assert sum(self_ns(spans).values()) == roots[0].duration_ns


def test_a_thread_with_nothing_open_takes_the_waiting_span(rec):
    got = {}

    def work():
        with P.span("bounce") as sp:
            got["rec"] = sp.rec
    with P.recording():
        with P.unit("step"):
            with P.span("replay.grad") as outer:
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
    assert not t.is_alive()
    assert got["rec"].parent == outer.rec.sid
    assert got["rec"].root == outer.rec.root
    assert got["rec"].thread != outer.rec.thread


def test_span_names_clear_of_the_benchmarks_filters(box, rec):
    scene, cam = box
    _, spans = _recorded_render(box)
    with P.recording():
        grad.image_loss_and_grad(grad.get_params(scene),
                                 torch.zeros((12, 16, 3)), scene, cam,
                                 RenderOptions(spp=1), SEED)
    wide, wcam = simple_box(48, 32, device="cpu")      # 1,536 lanes
    with P.recording():
        path.render(wide, wcam, RenderOptions(spp=1, alpha_shadows=True,
                                              compaction=(1.0, 0.5)), SEED)
    names = {s.name for s in P.recorded()}
    assert {"isect.transmit", "bounce.compact", "replay.grad"} <= names
    for name in names:
        assert not name.startswith("cu") and \
            not name.endswith("_RenderDiffBackward"), name
        assert all(part.isidentifier() for part in name.split(".")), name


def test_live_lanes_equal_collect_alive(box, rec):
    scene, cam = box
    n = cam.n_pixels
    lane = torch.arange(n, dtype=torch.int32)
    px, py = lane % cam.width, lane // cam.width
    o, d, _ = primary_ray(cam, px, py)
    _, counts = path.trace_rays(scene, cam, o, d, lane, 0, SEED, OPTS,
                                collect_alive=True)
    with P.recording():
        path.trace_rays(scene, cam, o, d, lane, 0, SEED, OPTS)
    spans = P.recorded()
    by_sid = {s.sid: s for s in spans}
    near = [s for s in spans if s.name == "isect.nearest"]
    assert len(near) == OPTS.max_depth + 2
    assert all(s.counts["lanes"] == n for s in near)
    live = [int(s.counts["live"]) for s in near]
    assert live[:-1] == counts[:-1].tolist()
    assert live[0] == n
    # the epilogue asks only about its pending lanes
    assert by_sid[near[-1].parent].name == "bounce.epilogue"
    assert 0 < live[-1] <= int(counts[-1])
    for s in spans:
        if s.name == "isect.anyhit":
            assert s.counts["lanes"] == n and 0 <= int(s.counts["live"]) <= n


def test_first_call_of_a_unit_recorded_whole(box, monkeypatch):
    scene, cam = box
    r = P.Recorder()
    monkeypatch.setattr(P, "RECORDER", r)
    path.render(scene, cam, OPTS, SEED)
    first = P.first_unit("render")
    assert first is not None and first.name == "render"
    spans = P.recorded()
    assert spans[-1] is first and len(spans) > 100
    assert r.depth == 0
    path.render(scene, cam, OPTS, SEED)
    assert len(P.recorded()) == len(spans) and P.first_unit("render") is first
    r.spans.clear()
    assert P.recorded() == [] and P.first_unit("render") is first


def test_buffer_is_bounded_and_phases_are_spans(monkeypatch):
    r = P.Recorder(capacity=4)
    monkeypatch.setattr(P, "RECORDER", r)
    prof = P.Profiler()
    with P.recording():
        for _ in range(3):
            with prof.phase("scene build", sync=False):
                with P.span("shade.hit"):
                    time.sleep(0)
    got = P.recorded()
    assert len(got) == 4 and len(prof.records) == 3
    assert [s.name for s in got] == ["shade.hit", "scene build"] * 2
    assert got[-2].parent == got[-1].sid and got[-1].parent is None


BDPT_OPTS = RenderOptions(spp=2, samples_per_launch=1, bdpt_max_path_length=7)


def _bdpt_spans(box):
    scene, cam = box
    with P.recording():
        img = bdpt.render(scene, cam, BDPT_OPTS, SEED)
    return img, P.recorded()


def test_bdpt_render_span_tree(box, rec):
    _, spans = _bdpt_spans(box)
    n = box[1].n_pixels
    kids = _children(spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["render"]
    assert all(s.root == roots[0].sid for s in spans)
    names = {s.name for s in spans}
    assert {"bdpt.eye", "bdpt.light", "bdpt.connect", "bdpt.splat",
            "isect.nearest", "isect.anyhit", "shade.bsdf",
            "rng"} <= names
    waves = BDPT_OPTS.spp // BDPT_OPTS.samples_per_launch
    for name, queries in (("bdpt.eye", 7), ("bdpt.light", 6)):
        got = [s for s in spans if s.name == name]
        assert len(got) == waves and all(s.parent == roots[0].sid
                                         for s in got)
        for s in got:
            assert [c.name for c in kids[s.sid]].count("isect.nearest") == \
                queries
    connects = [s for s in spans if s.name == "bdpt.connect"]
    assert len(connects) == waves
    for c in connects:
        assert c.counts["rays"] == 27 * n
        assert 0 < int(c.counts["live"]) <= c.counts["rays"]
        shadow = [k for k in kids[c.sid] if k.name == "isect.anyhit"]
        assert len(shadow) == 1
        assert shadow[0].counts["lanes"] == c.counts["rays"]
        assert int(shadow[0].counts["live"]) == int(c.counts["live"])
    assert all(s.parent == roots[0].sid for s in spans
               if s.name in ("bdpt.connect", "bdpt.splat"))
    assert sum(self_ns(spans).values()) == roots[0].duration_ns


def test_bdpt_splat_count_is_the_splats_on_the_film(box, rec, monkeypatch):
    landed = []

    def counting(film, idx, rgb):
        landed.append(sum(int((i >= 0).sum()) for i in idx))
        return splat_film(film, idx, rgb)
    monkeypatch.setattr(bdpt, "splat_film", counting)
    _, spans = _bdpt_spans(box)
    splats = [int(s.counts["splats"]) for s in spans
              if s.name == "bdpt.splat"]
    assert splats == landed and sum(splats) > 0


def test_bdpt_film_bit_equal_on_and_off(box, rec):
    scene, cam = box
    img_on, _ = _bdpt_spans(box)
    img_off = bdpt.render(scene, cam, BDPT_OPTS, SEED)
    assert torch.equal(img_on, img_off)


def _mesh_builder(n_side: int = 12):
    """A grid of 2 n_side^2 triangles and a light triangle above it ->
    (builder, every triangle's corners)."""
    b = SceneBuilder()
    white = b.add_material(diffuse=(0.7, 0.7, 0.7))
    light = b.add_material(emission=(5.0, 5.0, 5.0))
    g = np.linspace(-1.0, 1.0, n_side + 1)
    x0, z0 = np.meshgrid(g[:-1], g[:-1], indexing="ij")
    x1, z1 = x0 + g[1] - g[0], z0 + g[1] - g[0]
    corner = lambda x, z: np.stack([x, 0 * x, z], -1).reshape(-1, 3)
    a, b_, c, d = corner(x0, z0), corner(x0, z1), corner(x1, z1), \
        corner(x1, z0)
    grid = np.concatenate([np.stack([a, b_, c], 1), np.stack([a, c, d], 1)])
    lamp = np.array([[[-0.2, 1, -0.2], [0.2, 1, -0.2], [0.2, 1, 0.2]]])
    b.add_triangles(grid, None, None, white)
    b.add_triangles(lamp, None, None, light)
    return b, np.concatenate([grid, lamp]).astype(np.float32)


@pytest.mark.parametrize("use_bvh", [True, False])
def test_tables_build_span_on_the_cluster_branch_only(rec, use_bvh):
    b, verts = _mesh_builder()
    with P.recording():
        scene = b.build(use_bvh=use_bvh, device="cpu")
    built = [s for s in P.recorded() if s.name == "tables.build"]
    assert (scene.clusters is not None) == use_bvh
    if not use_bvh:
        assert built == []
        return
    assert len(built) == 1 and built[0].parent is None
    tables = build_clusters(verts)
    assert built[0].counts == {
        "triangles": len(verts),
        "clusters": int((tables["tri_idx"] >= 0).any(axis=1).sum())}
    assert built[0].duration_ns > 0


def test_bdpt_and_tables_record_nothing_off(box, rec):
    scene, cam = box
    bdpt.render(scene, cam, BDPT_OPTS, SEED)
    _mesh_builder()[0].build(use_bvh=True, device="cpu")
    assert P.recorded() == []
    assert P.span("bdpt.connect") is P.OFF and P.span("tables.build") is P.OFF


def test_paused_records_nothing_and_restores_the_recording(rec):
    assert not P.recording_on()
    with P.recording():
        assert P.recording_on()
        with P.paused():
            assert not P.recording_on() and P.span("bdpt.connect") is P.OFF
        assert P.recording_on()
        with P.span("after"):
            pass
    assert not P.recording_on() and rec.depth == 0
    assert [s.name for s in P.recorded()] == ["after"]


def test_bdpt_on_the_cpu_captures_no_graph(box, rec):
    scene, cam = box
    before = dict(cuda_graph._CAPTURED)
    bdpt.render(scene, cam, BDPT_OPTS, SEED)
    with P.recording():
        bdpt.render(scene, cam, BDPT_OPTS, SEED)
    assert cuda_graph._CAPTURED == before
    assert (id(scene), "bdpt") not in cuda_graph._CAPTURED


def test_bdpt_capture_keeps_every_tensor_of_scene_and_camera(box):
    scene, cam = box
    leaves = cuda_graph.leaves((scene, cam))
    ids = {id(t) for t in leaves}
    assert id(cam.world2raster) in ids and id(cam.position.x) in ids
    assert id(scene.materials.diffuse.x) in ids and id(scene.eta) in ids
    assert id(scene.diffuse_maps.rgb) in ids
    assert all(isinstance(t, torch.Tensor) for t in leaves)
