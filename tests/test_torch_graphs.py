"""The integrators' wavefronts replayed from CUDA graphs
(``utils/cuda_graph.py::run``), on a 16x12 ``simple_box`` on the CPU,
where no graph is captured:

- off the card every wavefront of the path tracer and of BDPT runs
  eagerly, counted in ``EAGER``, and no capture is made;
- with a stand-in for ``Graph`` (capturing runs nothing, a replay runs the
  captured function, as a replay runs its launches) and the card's rule
  for when graphs apply: the path tracer's renders after the first replay,
  bit-equal to the eager renders; a change of camera, options, seed,
  samples a wavefront or the dense kernels' form is refused by the
  capture's key (that render's first wavefront runs eagerly and a new
  capture replaces the old); while ``intersect_core`` is rebound (not the
  entry point the capture ran) every wavefront runs eagerly, the wrapper
  sees every query and the capture stays;
- the benchmark's ``graph_replay_pct.*`` readers: the path tracer's
  replayed share of its wavefronts in percent, None without the counters.
"""
import dataclasses
import types

import pytest
import torch

import torch_port_util  # noqa: F401  (one intra-op thread a process)
from portbench import harness
from tuturenderer_tpu_torch.integrators import bdpt, path
from tuturenderer_tpu_torch.ops import intersect as TI
from tuturenderer_tpu_torch.options import RenderOptions
from tuturenderer_tpu_torch.scene.presets import simple_box
from tuturenderer_tpu_torch.utils import cuda_graph

OPTS = RenderOptions(spp=4, samples_per_launch=2, max_depth=3, jitter=True)
SEED = 2**31 + 7


@pytest.fixture
def box():
    return simple_box(16, 12, device="cpu")


class StandInGraph:
    """``cuda_graph.Graph`` on the CPU: the capture runs nothing and
    counts nothing; a replay runs the captured function."""

    def __init__(self, fn, device):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs as on the card, through ``StandInGraph``; the captures made
    are dropped after the test (a stand-in keeps its scene alive)."""
    eligible = cuda_graph.eligible
    card = types.SimpleNamespace(type="cuda")
    monkeypatch.setattr(cuda_graph, "Graph", StandInGraph)
    monkeypatch.setattr(cuda_graph, "eligible",
                        lambda dev, *args: eligible(card, *args))
    before = set(cuda_graph._CAPTURED)
    yield
    for key in set(cuda_graph._CAPTURED) - before:
        del cuda_graph._CAPTURED[key]


def _bits(img):
    return img.view(torch.int32)


@pytest.mark.parametrize("name", ["path", "bdpt"])
def test_off_the_card_every_wavefront_runs_eagerly(box, name):
    scene, cam = box
    mod, opts = (path, OPTS) if name == "path" else \
        (bdpt, dataclasses.replace(OPTS, bdpt_max_path_length=3))
    eager, replayed = dict(cuda_graph.EAGER), dict(cuda_graph.REPLAYED)
    for _ in range(2):
        mod.render(scene, cam, opts, SEED)
    assert cuda_graph.EAGER[name] - eager[name] == 2 * 2
    assert cuda_graph.REPLAYED == replayed
    assert (id(scene), name) not in cuda_graph._CAPTURED


def test_renders_after_the_first_replay_bit_equal(box, stand_in,
                                                  monkeypatch):
    scene, cam = box
    path.render(scene, cam, OPTS, SEED)
    assert cuda_graph._CAPTURED[(id(scene), "path")].graph is not None
    eager, replayed = cuda_graph.EAGER["path"], cuda_graph.REPLAYED["path"]
    got = [path.render(scene, cam, OPTS, SEED, sample_base=b)
           for b in (0, 4)]
    assert cuda_graph.REPLAYED["path"] - replayed == 2 * 2
    assert cuda_graph.EAGER["path"] == eager
    monkeypatch.setattr(cuda_graph, "ON", False)
    want = [path.render(scene, cam, OPTS, SEED, sample_base=b)
            for b in (0, 4)]
    assert cuda_graph.EAGER["path"] - eager == 2 * 2
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("change", ["camera", "options", "seed",
                                    "samples a wavefront", "dense form",
                                    "entry point"])
def test_the_capture_refuses_a_change(box, stand_in, monkeypatch, change):
    scene, cam = box
    path.render(scene, cam, OPTS, SEED)
    cap = cuda_graph._CAPTURED[(id(scene), "path")]
    opts, seed, seen = OPTS, SEED, []
    if change == "camera":
        cam = dataclasses.replace(cam)        # the same values
    elif change == "options":
        opts = dataclasses.replace(OPTS, max_depth=4)
    elif change == "seed":
        seed = SEED + 1
    elif change == "samples a wavefront":
        opts = dataclasses.replace(OPTS, samples_per_launch=4)
    elif change == "dense form":
        monkeypatch.setattr(TI, "DENSE_KERNEL", "mt")
    else:
        real = path.intersect_core

        def counting(*args, **kw):
            seen.append(1)
            return real(*args, **kw)
        monkeypatch.setattr(path, "intersect_core", counting)
    eager, replayed = cuda_graph.EAGER["path"], cuda_graph.REPLAYED["path"]
    got = path.render(scene, cam, opts, seed)
    assert cuda_graph.EAGER["path"] > eager
    again = path.render(scene, cam, opts, seed)
    now = cuda_graph._CAPTURED[(id(scene), "path")]
    if change == "entry point":
        # two renders of two wavefronts, max_depth + 1 bounces and the
        # epilogue each
        assert len(seen) == 2 * 2 * (3 + 2)
        assert now is cap and cuda_graph.REPLAYED["path"] == replayed
    else:
        assert now is not cap and cuda_graph.REPLAYED["path"] > replayed
    monkeypatch.setattr(cuda_graph, "ON", False)
    want = path.render(scene, cam, opts, seed)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(want))


@pytest.mark.parametrize("cell", ["preview", "batch"])
def test_graph_replay_share_reader(monkeypatch, cell):
    read = harness.load_reader(f"graph_replay_pct.{cell}")
    monkeypatch.setattr(cuda_graph, "REPLAYED", {"path": 297, "bdpt": 40})
    monkeypatch.setattr(cuda_graph, "EAGER", {"path": 3, "bdpt": 2})
    assert read(None, None) == pytest.approx(99.0)
    monkeypatch.setattr(cuda_graph, "REPLAYED", {"path": 0, "bdpt": 4})
    monkeypatch.setattr(cuda_graph, "EAGER", {"path": 0, "bdpt": 1})
    assert read(None, None) is None
    monkeypatch.delattr(cuda_graph, "REPLAYED")
    monkeypatch.delattr(cuda_graph, "EAGER")
    assert read(None, None) is None
