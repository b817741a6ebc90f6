"""The inverse-rendering loop: steps of material optimisation.

One step is one iteration of ``grad.invert_materials``' loop:
``image_loss_and_grad`` against the target image (the L2 loss of the
differentiable render and its gradient through the path-replay backward
pass), plain gradient descent on the eight material leaves, and
``project_params``; step ``k`` renders at seed ``seed + k``, and its loss
is read on the host, as the loop does. Steps run back to back.

Set-up builds the one optimisation state (scene, camera, target, the
leaves) and drives it through its first ``first_steps`` steps with the
window's own step, keeping each loss, the gradient of the first step and
the leaves after the last; the window then goes on from that state.

The check: the plain reference follows the same first steps from the same
leaves, target and seeds, with autograd through its detached-sampling
estimator, and the program is held to it by three numbers:

- ``loss_gap``: the largest relative gap between the two losses of a step;
- ``grad_gap``: of the first step's gradient, over the leaves, the largest
  gap between the program's norm of a leaf and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of the leaves' change over the first steps,
  over the leaves the reference's gradient moves (at least a thousandth of
  the median leaf's gradient norm; the others move by rounding alone).
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import reference, scenes

@dataclasses.dataclass
class State:
    cell: object
    seed: int
    width: int
    height: int
    arrays: dict
    scene: object
    cam: object
    opts: object
    target: torch.Tensor
    params: object
    lr: float
    step_index: int = 0
    losses: list = dataclasses.field(default_factory=list)
    first_grad: list = None
    leaves0: list = None
    leaves_after: list = None
    nonfinite: int = 0
    info: dict = dataclasses.field(default_factory=dict)


def make_target(seed: int, height: int, width: int, scale: float, device):
    """The target image, drawn from the seed on the device: uniform in
    [0, scale) per pixel and channel."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((height, width, 3), generator=g, device=device) * scale


def setup(cell, seed: int, device) -> State:
    from tuturenderer_tpu_torch import grad
    from tuturenderer_tpu_torch.options import RenderOptions
    tr, cfg = cell.traffic, cell.config
    arrays = scenes.scene_arrays(cfg)
    t = time.perf_counter()
    scene = scenes.build_program_scene(arrays, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    info = {"table_build_s": time.perf_counter() - t,
            "n_tris": scenes.n_triangles(arrays)}
    w, h, spp = tr["width"], tr["height"], tr["spp_per_step"]
    cam = scenes.program_camera(cfg["camera"], w, h, device)
    ig = cfg["integrator"]
    opts = RenderOptions(spp=spp, samples_per_launch=spp,
                         max_depth=ig["max_depth"], min_depth=ig["min_depth"],
                         mis=ig["mis"],
                         russian_roulette=ig["russian_roulette"])
    st = State(cell=cell, seed=seed, width=w, height=h,
               arrays=arrays, scene=scene, cam=cam, opts=opts,
               target=make_target(seed, h, w, tr["target_scale"], device),
               params=grad.get_params(scene), lr=float(tr["lr"]), info=info)
    st.leaves0 = [a.detach().clone() for a in st.params.leaves()]
    for _ in range(tr["first_steps"]):
        unit(st)
    st.leaves_after = [a.detach().clone() for a in st.params.leaves()]
    return st


def unit(st: State) -> float:
    """One step; returns its wall time in seconds."""
    from tuturenderer_tpu_torch import grad
    t = time.perf_counter()
    loss, g = grad.image_loss_and_grad(st.params, st.target, st.scene,
                                       st.cam, st.opts,
                                       st.seed + st.step_index)
    st.params = grad.project_params(grad.MaterialParams.from_leaves(
        [w.detach() - st.lr * gr for w, gr in zip(st.params.leaves(),
                                                   g.leaves())]))
    value = float(loss)
    dt = time.perf_counter() - t
    if value != value or abs(value) == float("inf"):
        st.nonfinite += 1
    if st.first_grad is None:
        st.first_grad = [a.detach().clone() for a in g.leaves()]
    st.losses.append(value)
    st.step_index += 1
    return dt


def window(st: State, seconds: float) -> dict:
    n = 0
    t0 = time.perf_counter()
    while True:
        unit(st)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    st.info["window_steps"] = n
    print(f"window: {n} steps in {wall:.3f} s", file=sys.stderr)
    return {"values": {"step_s": wall / n}, "attempted": n,
            "failed": st.nonfinite}


# ------------------------------------------------------------ the reference

def project(leaves):
    """``project_params``' ranges: diffuse and metallic in [0, 1],
    emission >= 0, roughness in [1e-3, 1]."""
    lo = [0.0] * 6 + [1e-3, 0.0]
    hi = [1.0] * 3 + [None] * 3 + [1.0, 1.0]
    return [torch.clamp(a, min=l, max=h) for a, l, h in zip(leaves, lo, hi)]


def reference_step(st: State, leaves, step: int, dtype, spp=None,
                   block: int = 1 << 16):
    """The reference's loss and leaf gradients at ``leaves`` for step
    ``step``: the L2 loss of its differentiable render against the target,
    summed over blocks of pixels (the loss adds over pixels, so each
    block's backward adds its share of the gradient)."""
    device = st.target.device
    cfg = st.cell.config
    spp = spp or st.opts.spp
    p = st.width * st.height
    leaves = [a.detach().to(dtype).requires_grad_(True) for a in leaves]
    scene = reference.RefScene(st.arrays, device, dtype=dtype)
    target = st.target.reshape(-1, 3)
    n = target.numel()
    total = 0.0
    samples = torch.arange(spp, device=device)
    for lo in range(0, p, block):
        scene.set_materials(leaves)
        pix = torch.arange(lo, min(lo + block, p), device=device)
        lane = pix.repeat(spp)
        smp = samples.repeat_interleave(len(pix))
        o, d = reference.camera_rays(cfg["camera"], st.width, st.height,
                                     lane, dtype, device)
        rad = reference.trace(scene, o, d, lane, smp, st.seed + step,
                              cfg["integrator"], differentiable=True)
        img = rad.float().reshape(spp, len(pix), 3).sum(0) / spp
        loss = ((img - target[pix]) ** 2).sum() / n
        loss.backward()
        total += float(loss.detach())
    grads = [torch.zeros_like(a) if a.grad is None else a.grad.float()
             for a in leaves]
    return total, grads


def follow(st: State, dtype, spp=None):
    """The reference through the first steps -> (losses, first gradient,
    leaves after)."""
    leaves = [a.float() for a in st.leaves0]
    losses, first = [], None
    for k in range(st.cell.traffic["first_steps"]):
        loss, g = reference_step(st, leaves, k, dtype, spp)
        losses.append(loss)
        first = g if first is None else first
        leaves = project([(w - st.lr * gr).float()
                          for w, gr in zip(leaves, g)])
    return losses, first, leaves


def gaps(losses, grad, after, ref_losses, ref_grad, ref_after, leaves0):
    """The three compared numbers of a program (or a stand-in) against the
    reference's readings."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gn = [float(g.norm()) for g in grad]
    rn = [float(g.norm()) for g in ref_grad]
    med = float(np.median(rn))
    grad_gap = max(abs(a - b) / max(b, med) for a, b in zip(gn, rn))
    ch = [float((a - b).norm()) for a, b in zip(after, leaves0)]
    rch = [float((a - b).norm()) for a, b in zip(ref_after, leaves0)]
    moved = [i for i, b in enumerate(rn) if b >= 1e-3 * med]
    med_ch = float(np.median([rch[i] for i in moved]))
    change_gap = max(abs(ch[i] - rch[i]) / max(rch[i], med_ch)
                     for i in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def check(st: State, control: bool = False, half: bool = False) -> dict:
    """-> the three numbers. The program's state is freed first.
    ``control`` puts the reference in bfloat16 in the program's place;
    ``half`` puts the reference over half the samples a step there (the
    half-batch fault)."""
    st.scene = st.cam = st.params = None
    if st.target.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow(st, torch.float32)
    if control:
        got = follow(st, torch.bfloat16)
    elif half:
        got = follow(st, torch.float32, spp=max(1, st.opts.spp // 2))
    else:
        got = (st.losses[:st.cell.traffic["first_steps"]], st.first_grad,
               st.leaves_after)
    leaves0 = [a.float() for a in st.leaves0]
    return gaps(*got, *ref, leaves0)
