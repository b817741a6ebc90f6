"""Differentiable rendering: gradients of the image with respect to the
material parameters (albedo, emission, roughness, metallic).

The port of ``tuturenderer_tpu/grad.py``'s path-tracing half. The estimator
of ``integrators/path.py`` with ``opts.differentiable=True`` detaches every
sampling decision (directions, light points, pdfs, Russian-roulette
probabilities and MIS weights), so autograd through the bounce loop gives
the detached path-replay gradient: exact for the parameters the sampler
does not importance-sample (albedo, emission; roughness and metallic under
the NEE-only estimator, metallic under full MIS) and a low-bias estimate
for roughness under full MIS (``tests/test_grad.py``).

The material table is gathered per lane by plain indexing, whose autograd
backward is the scatter-add the JAX package writes as a custom VJP.
``render_light_diff`` and ``render_bdpt_diff`` come with the BDPT
integrator (ROADMAP queue 1 item 12b): the light tracer's replayed backward
has to route gradients through its direct pane's max-combine.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .camera import Camera
from .integrators.path import _block_order, render_sample
from .options import RenderOptions
from .scene.data import TRIANGLE, SceneData
from .utils.device import DEFAULT_DEVICE, resolve
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


class _Frame:
    """What one differentiable render needs besides the parameters: the
    lane layout of ``render`` (32x32 screen blocks, ``samples_per_launch``
    spp per wavefront) and how the per-pixel sums become the image."""

    def __init__(self, scene: SceneData, cam: Camera, opts: RenderOptions,
                 seed):
        self.scene, self.cam, self.seed = scene, cam, seed
        self.opts = dataclasses.replace(opts, differentiable=True)
        dev = scene.device
        self.p = cam.n_pixels
        order_np = _block_order(cam.width, cam.height)
        self.inv_order = torch.from_numpy(np.argsort(order_np)).to(dev) \
            .long()
        sb = max(1, min(self.opts.samples_per_launch or 1, self.opts.spp))
        while self.opts.spp % sb:
            sb -= 1
        self.sb = sb
        self.pix = torch.from_numpy(order_np).to(dev).repeat(sb)
        self.soff = torch.arange(sb, dtype=torch.int32, device=dev) \
            .repeat_interleave(self.p)

    @property
    def batches(self) -> int:
        return self.opts.spp // self.sb

    def batch(self, leaves, s: int):
        """The per-pixel radiance sums [3, p] of sample batch ``s`` at the
        parameters ``leaves`` (lane order)."""
        scene = put_params(self.scene, MaterialParams.from_leaves(leaves))
        px = self.pix % self.cam.width
        py = self.pix // self.cam.width
        L = render_sample(scene, self.cam, px, py, self.pix,
                          s * self.sb + self.soff, self.seed, self.opts)
        return torch.stack([c.reshape(self.sb, self.p).sum(0) for c in L])

    def image(self, acc: torch.Tensor) -> torch.Tensor:
        """[3, p] sums over every sample -> the [H, W, 3] image."""
        img = (acc * (1.0 / self.opts.spp)).T
        return img[self.inv_order].reshape(self.cam.height, self.cam.width, 3)


class _RenderDiff(torch.autograd.Function):
    """The image as a function of the eight parameter leaves. The forward
    pass renders batch after batch and keeps nothing of them; the backward
    pass replays one batch at a time with autograd on and takes its
    vector-Jacobian product, so memory is that of one batch whatever the
    spp: the JAX package's ``jax.checkpoint`` inside ``lax.scan``. Each
    bounce of the replay is checkpointed again (``integrators/path.py``),
    so a batch's backward holds one bounce's intermediates at a time."""

    @staticmethod
    def forward(ctx, frame: _Frame, *leaves):
        ctx.frame = frame
        ctx.save_for_backward(*leaves)
        acc = sum(frame.batch(leaves, s) for s in range(frame.batches))
        return frame.image(acc)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_img):
        frame, leaves = ctx.frame, ctx.saved_tensors
        with torch.enable_grad():
            acc = torch.zeros((3, frame.p), dtype=grad_img.dtype,
                              device=grad_img.device, requires_grad=True)
            grad_acc, = torch.autograd.grad(frame.image(acc), acc, grad_img)
        grads = [torch.zeros_like(a) for a in leaves]
        for s in range(frame.batches):
            with torch.enable_grad():
                copies = [a.detach().requires_grad_(True) for a in leaves]
                got = torch.autograd.grad(frame.batch(copies, s), copies,
                                          grad_acc, allow_unused=True)
            grads = [g if d is None else g + d for g, d in zip(grads, got)]
        return (None, *grads)


def render_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                opts: RenderOptions, seed=0) -> torch.Tensor:
    """Differentiable full-frame render -> [H, W, 3].

    Lanes go in 32x32 screen-block order and ``opts.samples_per_launch``
    spp share one wavefront, as in ``render``; the per-pixel sums are those
    of the one-sample schedule. The backward pass replays one sample batch
    at a time (the path-replay backward pass), so memory stays O(1) in
    spp."""
    return _RenderDiff.apply(_Frame(scene, cam, opts, seed),
                             *params.leaves())


def render_light_diff(*args, **kwargs):
    raise NotImplementedError(
        "the differentiable light tracer comes with ROADMAP queue 1 item 12b")


def render_bdpt_diff(*args, **kwargs):
    raise NotImplementedError(
        "the differentiable BDPT renderer comes with ROADMAP queue 1 item 12b")


def image_loss_and_grad(params: MaterialParams, target: torch.Tensor,
                        scene: SceneData, cam: Camera, opts: RenderOptions,
                        seed=0):
    """L2 image loss against ``target`` and its gradient with respect to
    ``params`` -> (loss, MaterialParams of gradients): the core step of
    inverse-rendering loops. ``params`` are not modified."""
    leaves = [a.detach().requires_grad_(True) for a in params.leaves()]
    img = render_diff(MaterialParams.from_leaves(leaves), scene, cam, opts,
                      seed)
    loss = torch.mean((img - target) ** 2)
    # a parameter no lane reads (a type's field the scene never uses) has
    # gradient 0
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
