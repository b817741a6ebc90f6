"""Drive whole runs (set-up, window, check; not the look for a card) on
the CPU at tiny frames with the timed path broken underneath, and see
``correct`` come out false, once for each fault a cell can have:

- a render pass that leaves out half of its samples and takes the mean
  over the rest;
- a render whose radiance is altered, one lane in sixteen, where the
  bounce loop produces it;
- an inverse-rendering step that returns its state unchanged;
- a step whose loss and gradient leave out half of its samples;
- a step whose radiance is altered where it is produced.

(One card: no exchange between chips to leave out.) A sound run of the
same tiny cell comes out correct, so the faults, not the size, fail."""
import dataclasses
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 3_000_000_017

# 24 x 24, the frame of the reference tests: at 16 x 16 one camera ray of
# 256 at this seed leaves through the crack that the program's Woop test
# leaves on the quads' diagonals (a known fault of the program, read at the
# cells' own size in PERF.md), a share of the film far above what it is at
# 1024 x 1024, where the limits are set
RENDER = dict(width=24, height=24, spp_per_pass=2, samples_per_launch=2,
              check_pixels=576)
INVERT = dict(width=64, height=64)


def run(cell: str, traffic: dict) -> dict:
    c = harness.resolve_cell(ROOT, cell)
    c = dataclasses.replace(c, traffic=dict(c.traffic, **traffic))
    line = harness.drive(c, SEED, 0.0, False, CPU, time.perf_counter())
    assert line is not None
    return line


def half_render(monkeypatch):
    from tuturenderer_tpu_torch.integrators import path
    real = path.render

    def render(scene, cam, opts, seed=0, sample_base=0, stats=False):
        half = dataclasses.replace(opts, spp=opts.spp // 2,
                                   samples_per_launch=opts.spp // 2)
        return real(scene, cam, half, seed, sample_base, stats)
    monkeypatch.setattr(path, "render", render)


def altered_radiance(monkeypatch, module):
    real = module.render_sample

    def render_sample(scene, cam, px, py, lane, *args, **kw):
        out = real(scene, cam, px, py, lane, *args, **kw)
        L, rest = (out[0], out[1:]) if isinstance(out, tuple) and \
            not hasattr(out, "x") else (out, None)
        bump = torch.where(lane % 16 == 0, 0.5, 0.0)
        L = type(L)(L.x + bump, L.y, L.z)
        return (L, *rest) if rest is not None else L
    monkeypatch.setattr(module, "render_sample", render_sample)


def unchanged_state(monkeypatch):
    from tuturenderer_tpu_torch import grad
    real = grad.image_loss_and_grad

    def step(params, *args, **kw):
        loss, g = real(params, *args, **kw)
        return loss, grad.MaterialParams.from_leaves(
            [torch.zeros_like(a) for a in g.leaves()])
    monkeypatch.setattr(grad, "image_loss_and_grad", step)


def half_step(monkeypatch):
    from tuturenderer_tpu_torch import grad
    real = grad.image_loss_and_grad

    def step(params, target, scene, cam, opts, seed=0):
        half = dataclasses.replace(opts, spp=opts.spp // 2,
                                   samples_per_launch=opts.spp // 2)
        return real(params, target, scene, cam, half, seed)
    monkeypatch.setattr(grad, "image_loss_and_grad", step)


def test_sound_runs_are_correct():
    assert run("box_dense.preview", RENDER)["correct"]
    assert run("box_dense.invert", INVERT)["correct"]


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_render_fault_is_caught(monkeypatch, fault):
    from tuturenderer_tpu_torch.integrators import path
    if fault == "half":
        half_render(monkeypatch)
    else:
        altered_radiance(monkeypatch, path)
    assert not run("box_dense.preview", RENDER)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_invert_fault_is_caught(monkeypatch, fault):
    from tuturenderer_tpu_torch import grad
    {"unchanged": unchanged_state, "half": half_step,
     "altered": lambda m: altered_radiance(m, grad)}[fault](monkeypatch)
    assert not run("box_dense.invert", INVERT)["correct"]
