"""Differentiable rendering: gradients of the image with respect to the
material parameters (albedo, emission, roughness, metallic).

The port of ``tuturenderer_tpu/grad.py``: the path tracer
(``render_diff``), the light tracer (``render_light_diff``) and BDPT
(``render_bdpt_diff``). Each estimator with ``opts.differentiable=True``
detaches every sampling decision (directions, light points, pdfs,
Russian-roulette probabilities and MIS weights), so autograd through it
gives the detached path-replay gradient: exact for the parameters the
sampler does not importance-sample (albedo, emission; roughness and
metallic under the NEE-only estimator, metallic under full MIS) and a
low-bias estimate for roughness under full MIS (``tests/test_grad.py``).
The forward pass of each keeps nothing of its samples, and the backward
pass replays one sample batch at a time, so memory stays O(1) in spp.

The path tracer and BDPT go through ``_RenderDiff``, which drives the
integrator's frame (``integrators/frame.py``) as ``render`` does, so the
forward image is ``render``'s bit for bit at any ``samples_per_launch``.

The material table is gathered per lane by plain indexing, whose autograd
backward is the scatter-add the JAX package writes as a custom VJP.

Spans of ``utils/profiling.py``: ``image_loss_and_grad`` is a unit,
``step``; ``_RenderDiff`` opens ``replay.forward`` around its forward
pass and, in its backward pass, ``replay.batch`` around each batch's
forward and ``replay.grad`` around its ``torch.autograd.grad``, whose
child ``bounce`` spans are the checkpoint's recomputation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .camera import Camera
from .integrators.bdpt import BDPTFrame
from .integrators.light import (_slot, compose_light_film, splat_film,
                                trace_sample)
from .integrators.path import PathFrame, render_sample
from .options import RenderOptions
from .scene.data import TRIANGLE, SceneData
from .utils.device import DEFAULT_DEVICE, resolve
from .utils.profiling import span, unit
from .utils.vec import Vec3


class MaterialParams(NamedTuple):
    """The differentiable subset of the material table, [M] each."""
    diffuse: Vec3
    emission: Vec3
    roughness: torch.Tensor
    metallic: torch.Tensor

    def leaves(self):
        """The eight [M] tensors in the JAX package's flat leaf order:
        diffuse x y z, emission x y z, roughness, metallic."""
        return [*self.diffuse, *self.emission, self.roughness, self.metallic]

    @classmethod
    def from_leaves(cls, leaves) -> "MaterialParams":
        return cls(diffuse=Vec3(*leaves[0:3]), emission=Vec3(*leaves[3:6]),
                   roughness=leaves[6], metallic=leaves[7])


def get_params(scene: SceneData) -> MaterialParams:
    m = scene.materials
    return MaterialParams(diffuse=m.diffuse, emission=m.emission,
                          roughness=m.roughness, metallic=m.metallic)


def params_from_numpy(arrays: dict, device=DEFAULT_DEVICE) -> MaterialParams:
    """MaterialParams from the JAX ``MaterialParams`` flattened to numpy
    with dotted keys (``diffuse.x``, ..., ``emission.z``, ``roughness``,
    ``metallic``), as ``scene_from_numpy`` takes a scene."""
    device = resolve(device)
    t = lambda k: torch.from_numpy(
        np.array(arrays[k], np.float32)).to(device)
    return MaterialParams(
        diffuse=Vec3(*(t(f"diffuse.{c}") for c in "xyz")),
        emission=Vec3(*(t(f"emission.{c}") for c in "xyz")),
        roughness=t("roughness"), metallic=t("metallic"))


def put_params(scene: SceneData, p: MaterialParams) -> SceneData:
    """The scene with ``p`` installed in its material table, and its
    per-light emission table rebuilt from ``p.emission``: without that an
    emission edit would change direct hits but not the NEE contribution,
    and part of the emission gradient would be lost. The light list itself
    is the one built with the scene (ROADMAP queue 3 item 5)."""
    m = dataclasses.replace(scene.materials, diffuse=p.diffuse,
                            emission=p.emission, roughness=p.roughness,
                            metallic=p.metallic)
    scene = dataclasses.replace(scene, materials=m)
    if scene.n_lights:
        li = scene.light_idx.long()
        if scene.n_tris:
            tm = scene.tmat[torch.clamp(li, 0, scene.n_tris - 1)]
        else:
            tm = torch.zeros_like(li)
        if scene.n_spheres:
            sm = scene.smat[torch.clamp(li, 0, scene.n_spheres - 1)]
        else:
            sm = torch.zeros_like(li)
        mat = torch.where(scene.light_kind == TRIANGLE, tm, sm).long()
        em = m.emission
        scene = dataclasses.replace(scene, light_emission=Vec3(
            em.x[mat], em.y[mat], em.z[mat]))
    return scene


class _RenderDiff(torch.autograd.Function):
    """The image of an integrator's frame (``integrators/frame.py``) as a
    function of the eight parameter leaves. The forward pass steps the
    frame's batches from ``render``'s accumulators and keeps only them,
    so its image is ``render``'s bit for bit; the backward pass steps one
    batch at a time again, from new accumulators, and takes its
    vector-Jacobian product against the image's gradient with respect to
    the accumulators: memory is one batch's whatever the spp (the JAX
    package's ``jax.checkpoint`` inside ``lax.scan``), and one bounce's,
    as each bounce is checkpointed again (``integrators/path.py``)."""

    @staticmethod
    def forward(ctx, frame, *leaves):
        lanes = frame.lanes()
        with span("replay.forward"):
            scene = put_params(frame.scene, MaterialParams.from_leaves(leaves))
            outs = frame.accumulators()
            for first in frame.firsts:
                outs = frame.step(scene, outs, lanes, first)
        ctx.frame, ctx.lanes, ctx.outs = frame, lanes, outs
        ctx.save_for_backward(*leaves)
        return frame.image(outs, lanes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_img):
        frame, lanes, leaves = ctx.frame, ctx.lanes, ctx.saved_tensors
        # the image is linear in the accumulators but for BDPT's NaN mask,
        # which the forward's decide (the overflow count is an integer)
        with torch.enable_grad():
            outs = [o.detach().requires_grad_(o.is_floating_point())
                    for o in ctx.outs]
            grad_acc = torch.autograd.grad(
                frame.image(outs, lanes), [o for o in outs if o.requires_grad],
                grad_img)
        grads = [torch.zeros_like(a) for a in leaves]
        for first in frame.firsts:
            with torch.enable_grad():
                copies = [a.detach().requires_grad_(True) for a in leaves]
                with span("replay.batch"):
                    scene = put_params(frame.scene,
                                       MaterialParams.from_leaves(copies))
                    out = frame.step(scene, frame.accumulators(), lanes,
                                     first)
                with span("replay.grad"):
                    got = torch.autograd.grad(
                        [o for o in out if o.is_floating_point()], copies,
                        grad_acc, allow_unused=True)
            grads = [g if d is None else g + d for g, d in zip(grads, got)]
        return (None, *grads)


class _PathFrame(PathFrame):
    """``PathFrame`` sampling through this module's ``render_sample``, which
    the benchmark's planted faults rebind (``portbench/tests/``)."""
    sample = staticmethod(lambda *args, **kw: render_sample(*args, **kw))


def frame_image(frame_cls, params: MaterialParams, scene: SceneData,
                cam: Camera, opts: RenderOptions, seed=0, **tile):
    """``_RenderDiff`` at ``params`` of the ``frame_cls`` frame of a render
    with ``opts`` made ``differentiable`` (``tile``: ``Frame``'s
    ``pixels``, ``stride`` and ``offset``)."""
    opts = dataclasses.replace(opts, differentiable=True)
    return _RenderDiff.apply(frame_cls(scene, cam, opts, seed, **tile),
                             *params.leaves())


def render_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                opts: RenderOptions, seed=0) -> torch.Tensor:
    """Differentiable full-frame render -> [H, W, 3], on ``render``'s
    schedule (``PathFrame``), so its image is ``render``'s bit for bit. The
    backward pass replays one sample batch at a time (the path-replay
    backward pass), so memory stays O(1) in spp."""
    return frame_image(_PathFrame, params, scene, cam, opts, seed)


class _LightDiff(torch.autograd.Function):
    """The light-tracing image as a function of the eight parameter leaves.

    The vertex-connection splats add up, so their gradient is a replay's
    vector-Jacobian product, as in ``_RenderDiff``. The direct pane is a
    per-pixel channel max over the samples (``scatter_reduce`` "amax" over
    a zero film), and the JAX package differentiates it as one scatter-max
    a sample: its rule (``jax/_src/lax/slicing.py::_scatter_extremal_jvp``)
    splits a pixel's tangent evenly between the updates that equal the new
    value and the carry, when the carry equals it too. Chained over the
    samples, an update reaches the image only if it equals the final max D
    of its pixel, with the weight

        1 / (K_s + r_s) * prod over later samples s' of 1 / (K_s' + 1),

    K_s the sample's updates equal to D there, r_s 1 if an earlier sample
    (or the zero film, when D is 0) already held D. The forward pass keeps
    D and, per pixel and channel, the sample that first raised the pane to
    D (``first``, -1 for the zero film), O(p) in all, instead of each
    sample's carry (O(spp * p)); the backward pass replays the samples
    last to first, counts each one's K_s and carries the product, so it
    traces each sample once, as ``_RenderDiff`` does."""

    @staticmethod
    def forward(ctx, scene, cam, opts, seed, *leaves):
        ctx.args = (scene, cam, opts, seed)
        p = cam.n_pixels
        dev = scene.device
        splat = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
        direct = torch.zeros_like(splat)
        first = torch.full((p + 1, 3), -1, dtype=torch.int64, device=dev)
        dmask = torch.zeros((p + 1,), dtype=torch.bool, device=dev)
        for s in range(opts.spp):
            sp, slot, val = _light_sample(leaves, s, *ctx.args)
            splat = splat + sp
            direct, first = pane_max(direct, first, slot, val, s)
            dmask.index_fill_(0, slot, True)
        ctx.save_for_backward(splat, direct, first, dmask, *leaves)
        return _light_image(cam, scene, opts, splat, direct, dmask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_img):
        scene, cam, opts, seed = ctx.args
        splat, direct, first, dmask, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            parts = [a.detach().requires_grad_(True) for a in (splat, direct)]
            g_splat, g_direct = torch.autograd.grad(
                _light_image(cam, scene, opts, *parts, dmask), parts,
                grad_img)
        after = torch.ones_like(direct)      # prod of later 1 / (K + 1)
        grads = [torch.zeros_like(a) for a in leaves]
        for s in reversed(range(opts.spp)):
            with torch.enable_grad():
                copies = [a.detach().requires_grad_(True) for a in leaves]
                sp, slot, val = _light_sample(copies, s, *ctx.args)
                g_val, after = pane_shares(g_direct, after, direct, first,
                                           slot, val.detach(), s)
                outs = [(o, g) for o, g in ((sp, g_splat), (val, g_val))
                        if o.requires_grad]
                got = torch.autograd.grad([o for o, _ in outs], copies,
                                          [g for _, g in outs],
                                          allow_unused=True) if outs \
                    else [None] * len(copies)
            grads = [g if d is None else g + d for g, d in zip(grads, got)]
        return (None, None, None, None, *grads)


def pane_max(direct, first, slot, val, s: int):
    """One sample's step of the direct pane: ``direct`` [p + 1, 3] maxed
    with the sample's values ``val`` [n, 3] at their slots, and ``first``,
    per pixel and channel the sample that raised the pane to its value (-1
    while it is the zero film's)."""
    new = direct.scatter_reduce(0, slot[:, None].expand(-1, 3), val, "amax",
                                include_self=True)
    return new, torch.where(new > direct, s, first)


def pane_shares(g_direct, after, direct, first, slot, val, s: int):
    """The gradient of sample ``s``'s direct-pane values ``val`` [n, 3]
    given the gradient ``g_direct`` of the final pane ``direct`` and
    ``after``, the product of 1 / (K + 1) over the later samples; returns
    it and the product for the sample before (``_LightDiff``)."""
    tied = val == direct[slot]
    k = torch.zeros_like(direct).index_add_(0, slot, tied.to(direct.dtype))
    share = g_direct * after / torch.clamp(
        k + (first < s).to(direct.dtype), min=1.0)
    return torch.where(tied, share[slot], 0.0), after / (k + 1.0)


def _light_sample(leaves, s: int, scene, cam, opts, seed):
    """One light-tracing sample at the parameters ``leaves`` -> (its
    connection splats as a [p + 1, 3] film, the direct splat's slot [p]
    and value [p, 3])."""
    scene = put_params(scene, MaterialParams.from_leaves(leaves))
    p = cam.n_pixels
    lane = torch.arange(p, dtype=torch.int32, device=scene.device)
    idx_list, rgb_list, didx, drgb = trace_sample(scene, cam, lane, s, seed,
                                                  opts)
    film = torch.zeros((p + 1, 3), dtype=torch.float32, device=scene.device)
    return splat_film(film, idx_list[1:], rgb_list[1:]), _slot(didx, p), \
        torch.stack(tuple(drgb), -1)


def _light_image(cam, scene, opts, splat, direct, dmask):
    """The [H, W, 3] light-tracing image of the p + 1 slot films."""
    p, hw = cam.n_pixels, (cam.height, cam.width)
    return compose_light_film(scene, cam, splat[:p].reshape(*hw, 3),
                              direct[:p].reshape(*hw, 3),
                              dmask[:p].reshape(*hw), opts.spp)


def render_light_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                      opts: RenderOptions, seed=0) -> torch.Tensor:
    """Differentiable light-tracing render -> [H, W, 3], one lane per
    pixel and one sample a pass, as ``integrators/light.render``. The
    connection splats differentiate as sums; the direct pane's max-combine
    routes each pixel's gradient as the JAX package's scatter-max does
    (``_LightDiff``). Sampling decisions are detached inside
    ``trace_sample``: gradients flow through emission, the adjoint BSDF
    values and the We/Geo throughput chain. Memory O(1) in spp."""
    opts = dataclasses.replace(opts, differentiable=True)
    return _LightDiff.apply(scene, cam, opts, seed, *params.leaves())


def render_bdpt_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                     opts: RenderOptions, seed=0) -> torch.Tensor:
    """Differentiable BDPT render -> [H, W, 3]. The per-pixel estimates
    and the t=1 splats both differentiate; MIS weights and every sampling
    decision are detached (``integrators/bdpt.py``), so gradients flow
    through the two subpaths' BSDF values, emission and the connection
    geometry terms. The schedule is ``bdpt.render``'s (``BDPTFrame``,
    ``samples_per_launch`` samples a wavefront), so the image is its bit
    for bit; the backward pass replays one batch at a time
    (``_RenderDiff``), memory O(1) in spp."""
    return frame_image(BDPTFrame, params, scene, cam, opts, seed)


def image_loss_and_grad(params: MaterialParams, target: torch.Tensor,
                        scene: SceneData, cam: Camera, opts: RenderOptions,
                        seed=0):
    """L2 image loss against ``target`` and its gradient with respect to
    ``params`` -> (loss, MaterialParams of gradients): the core step of
    inverse-rendering loops. ``params`` are not modified."""
    with unit("step"):
        leaves = [a.detach().requires_grad_(True) for a in params.leaves()]
        img = render_diff(MaterialParams.from_leaves(leaves), scene, cam,
                          opts, seed)
        loss = torch.mean((img - target) ** 2)
        # a parameter no lane reads (a type's field the scene never uses)
        # has gradient 0
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), MaterialParams.from_leaves(
        [torch.zeros_like(a) if g is None else g
         for a, g in zip(leaves, grads)])


def project_params(p: MaterialParams) -> MaterialParams:
    """Each parameter clipped into its valid range: diffuse and metallic
    to [0, 1], emission to >= 0, roughness to [1e-3, 1]."""
    return MaterialParams(
        diffuse=Vec3(*(torch.clamp(a, 0.0, 1.0) for a in p.diffuse)),
        emission=Vec3(*(torch.clamp(a, min=0.0) for a in p.emission)),
        roughness=torch.clamp(p.roughness, 1e-3, 1.0),
        metallic=torch.clamp(p.metallic, 0.0, 1.0))


def invert_materials(params: MaterialParams, target: torch.Tensor,
                     scene: SceneData, cam: Camera, opts: RenderOptions,
                     steps: int, lr: float, seed=0):
    """The inverse-rendering loop of the JAX package's ``cli.py --invert``:
    ``steps`` steps of plain gradient descent on the L2 image loss against
    ``target`` (linear radiance), each at seed ``seed + step`` and followed
    by ``project_params``. Returns (recovered params, the loss at each
    step)."""
    losses = []
    for step in range(steps):
        loss, g = image_loss_and_grad(params, target, scene, cam, opts,
                                      seed + step)
        params = project_params(MaterialParams.from_leaves(
            [w.detach() - lr * gr
             for w, gr in zip(params.leaves(), g.leaves())]))
        losses.append(float(loss))
    return params, losses
