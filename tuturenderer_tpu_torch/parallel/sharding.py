"""Multi-GPU rendering and training: pixel-tile x sample data parallelism
over a mesh of ranks, with the scene replicated and the films and
gradients all-reduced.

The port of ``tuturenderer_tpu/parallel/sharding.py`` to
``torch.distributed`` (``parallel/distributed.py``). The reference's only
parallel layer is std::thread row slicing on one CPU (PathTracing.hpp:
393-430). Each rank (one process, one card) holds the whole scene and
traces:

- its pixel tile: the contiguous slice of ``arange(p_pad)`` (the pixels,
  padded to a multiple of the pixel shards) at its coordinates on the
  pixel axes (every axis but ``sample``);
- its samples: ``gs = s * n_sample + sample_id`` for s < spp / n_sample,
  interleaved over the ``sample`` axis.

The RNG is keyed by (pixel, global sample), so every mesh renders the
single-device image up to float order. Partial films are summed over the
``sample`` group and the tiles gathered over the pixel group; every rank
returns the whole image, as JAX's result is replicated. Light paths are
not tied to pixels: the light tracer's and BDPT's splats go into
full-frame films reduced over every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..camera import Camera
from ..grad import MaterialParams, frame_image
from ..integrators.light import _slot, compose_light_film, splat_film
from ..integrators.path import PathFrame, render_sample
from ..options import RenderOptions
from ..scene.data import SceneData
from .distributed import Mesh, all_gather, all_reduce, new_mesh
from .distributed import pixel_axes as _pixel_axes


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Factor the world's ranks into a (tile, sample) mesh, favoring the
    tile axis (film partitioning) for the larger factor. ``n_devices``,
    where given, must be the world size."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {n}")
    sample = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= cand:
            sample = cand
            break
    return new_mesh(("tile", "sample"), (n // sample, sample))


def _padded_lane_count(n_pixels: int, n_tile: int) -> int:
    return ((n_pixels + n_tile - 1) // n_tile) * n_tile


def _n_pixel_shards(mesh: Mesh) -> int:
    n = 1
    for a in _pixel_axes(mesh):
        n *= mesh.shape[a]
    return n


def _pixel_shard(mesh: Mesh) -> int:
    """This rank's index among the pixel shards (row-major over the pixel
    axes: the order of the pixel group's ranks)."""
    i = 0
    for a in _pixel_axes(mesh):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _samples(opts: RenderOptions, mesh: Mesh):
    """(n_sample, this rank's sample_id, spp per sample rank)."""
    n_sample = mesh.shape["sample"]
    if opts.spp % n_sample:
        raise ValueError(f"spp={opts.spp} must divide by the sample axis "
                         f"{n_sample}")
    return n_sample, mesh.coords["sample"], opts.spp // n_sample


def _lanes(cam: Camera, mesh: Mesh, device) -> torch.Tensor:
    """This rank's lanes: the pixel ids (int32) of its tile of the lane
    axis, padded to a multiple of the pixel shards."""
    n_tile = _n_pixel_shards(mesh)
    m = _padded_lane_count(cam.n_pixels, n_tile) // n_tile
    start = _pixel_shard(mesh) * m
    return torch.arange(start, start + m, dtype=torch.int32, device=device)


def _screen(lane, cam: Camera):
    """(px, py) of lanes, py clamped so padded lanes stay on the film."""
    return lane % cam.width, torch.clamp(lane // cam.width,
                                         max=cam.height - 1)


def _gather_tiles(tile: torch.Tensor, cam: Camera, mesh: Mesh):
    """Every rank's [m, 3] tile -> the [H, W, 3] image."""
    img = all_gather(tile, mesh, _pixel_axes(mesh))[:cam.n_pixels]
    return img.reshape(cam.height, cam.width, 3)


def render_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                   mesh: Mesh, seed: int = 0) -> torch.Tensor:
    """Full-frame path-traced render distributed over ``mesh`` -> [H, W, 3]
    on the scene's device, the same on every rank.

    Pixels are sharded over the pixel axes; each 'sample' rank traces an
    interleaved subset of the spp, one sample of its tile a wavefront, and
    the partial films (each scaled by 1/spp) are summed over the sample
    group."""
    n_sample, sample_id, spp_local = _samples(opts, mesh)
    lane = _lanes(cam, mesh, scene.device)
    px, py = _screen(lane, cam)
    acc = [torch.zeros(lane.shape, dtype=torch.float32, device=lane.device)
           for _ in range(3)]
    for s in range(spp_local):
        L = render_sample(scene, cam, px, py, lane, s * n_sample + sample_id,
                          seed, opts)
        acc = [acc[0] + L.x, acc[1] + L.y, acc[2] + L.z]
    inv = 1.0 / opts.spp
    film = torch.stack([a * inv for a in acc], dim=-1)
    return _gather_tiles(all_reduce(film, mesh, ("sample",)), cam, mesh)


def render_light_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                         mesh: Mesh, seed: int = 0) -> torch.Tensor:
    """Light-tracing render distributed over ``mesh`` -> [H, W, 3], the
    same on every rank.

    Light paths are not tied to pixels, so the lane axis (path slots) is
    sharded; every rank splats into full-frame partial films. Padded lanes
    (>= p) are masked: they would draw RNG streams no single-device render
    draws. The vertex-connection splats are summed over every rank (the
    all-reduce in place of the reference's mutex-guarded addRGB,
    LightTracing.hpp:181-200); the direct pane has overwrite semantics
    with equal values, so the partial panes and masks combine by max. The
    film is composed as ``integrators/light.render`` composes it:
    background where no direct splat landed, NaN to 0."""
    from ..integrators.light import trace_sample
    n_sample, sample_id, spp_local = _samples(opts, mesh)
    lane = _lanes(cam, mesh, scene.device)
    p = cam.n_pixels
    live = lane < p
    dev = lane.device
    splat = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
    direct = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
    dmask = torch.zeros((p + 1,), dtype=torch.int32, device=dev)
    for s in range(spp_local):
        idx_list, rgb_list, didx, drgb = trace_sample(
            scene, cam, lane, s * n_sample + sample_id, seed, opts)
        dslot = _slot(torch.where(live, didx, -1), p)
        direct.scatter_reduce_(0, dslot[:, None].expand(-1, 3),
                               torch.stack(tuple(drgb), dim=-1), "amax",
                               include_self=True)
        dmask.index_fill_(0, dslot, 1)
        splat = splat_film(splat, [torch.where(live, i, -1)
                                   for i in idx_list[1:]], rgb_list[1:])
    every = tuple(mesh.axis_names)
    splat = all_reduce(splat[:p], mesh, every)
    direct = all_reduce(direct[:p], mesh, every, dist.ReduceOp.MAX)
    dmask = all_reduce(dmask[:p], mesh, every, dist.ReduceOp.MAX)
    hw = (cam.height, cam.width)
    return compose_light_film(scene, cam, splat.reshape(*hw, 3),
                              direct.reshape(*hw, 3),
                              dmask.reshape(*hw) > 0, opts.spp)


def render_bdpt_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                        mesh: Mesh, seed: int = 0) -> torch.Tensor:
    """BDPT render distributed over ``mesh`` -> [H, W, 3], the same on
    every rank. The per-pixel strategy estimates stay with the tile that
    owns the pixel and are summed over the sample group; the t=1 splats go
    into full-frame partial films summed over every rank (the collective
    in place of the reference's mutex addRGB, BDPT.hpp:819-832). The
    background underlies every pixel (Camera.hpp:28) and is added once,
    after the reductions; NaN pixels become 0."""
    from ..integrators.bdpt import render_sample_bdpt
    n_sample, sample_id, spp_local = _samples(opts, mesh)
    lane = _lanes(cam, mesh, scene.device)
    px, py = _screen(lane, cam)
    p = cam.n_pixels
    live = lane < p
    dev = lane.device
    spp_inv = 1.0 / opts.spp
    est = torch.zeros((lane.shape[0], 3), dtype=torch.float32, device=dev)
    splat = torch.zeros((p + 1, 3), dtype=torch.float32, device=dev)
    for s in range(spp_local):
        e, sidx, srgb = render_sample_bdpt(scene, cam, px, py, lane,
                                           s * n_sample + sample_id, seed,
                                           opts)
        est = est + torch.stack(tuple(e), dim=-1) * spp_inv
        # the splats carry 1/spp already
        splat = splat_film(splat, [torch.where(live, i, -1) for i in sidx],
                           srgb)
    est = _gather_tiles(all_reduce(est, mesh, ("sample",)), cam, mesh)
    splat = all_reduce(splat[:p], mesh, tuple(mesh.axis_names))
    img = est + splat.reshape(est.shape) + \
        torch.stack(tuple(scene.bkgcolor)).to(torch.float32)
    return torch.where(torch.isnan(img), 0.0, img)


def image_loss_and_grad_sharded(params: MaterialParams, target,
                                scene: SceneData, cam: Camera,
                                opts: RenderOptions, mesh: Mesh, seed=0):
    """``grad.image_loss_and_grad`` distributed over ``mesh`` -> (loss,
    MaterialParams of gradients), the same on every rank and equal to the
    single-device pair up to float order.

    Each rank renders its tile's partial film through the path tracer's
    frame over the tile's pixels, its samples ``gs = s * n_sample +
    sample_id`` batched ``samples_per_launch`` at a time, under
    ``grad._RenderDiff`` (the forward pass keeps the accumulators; the
    backward pass replays one sample batch at a time, memory O(1) in spp);
    the partials are summed over the sample group to give the film; the
    loss is mean((film - target)^2) over H*W*3; d loss / d film =
    2 (film - target) / (3p) is the same on every sample rank, and each
    rank's replay takes it for its own partial; the gradients are summed
    over every rank."""
    n_sample, sample_id, _ = _samples(opts, mesh)
    lane = _lanes(cam, mesh, scene.device)
    leaves = [a.detach().requires_grad_(True) for a in params.leaves()]
    partial = frame_image(PathFrame, MaterialParams.from_leaves(leaves),
                          scene, cam, opts, seed, pixels=lane,
                          stride=n_sample, offset=sample_id)      # [m, 3]
    film = all_reduce(partial.detach(), mesh, ("sample",))
    p = cam.n_pixels
    tgt = torch.as_tensor(target, dtype=torch.float32, device=lane.device)
    if tuple(tgt.shape) != (cam.height, cam.width, 3):
        raise ValueError(f"target {tuple(tgt.shape)}, the camera renders "
                         f"{(cam.height, cam.width, 3)}")
    tgt = tgt.reshape(-1, 3)
    live = (lane < p)[:, None]
    diff = torch.where(live, film - tgt[torch.clamp(lane.long(), max=p - 1)],
                       0.0)
    loss = all_reduce((diff * diff).sum(), mesh, _pixel_axes(mesh)) / (3 * p)
    grads = torch.autograd.grad(partial, leaves, diff * (2.0 / (3 * p)))
    return loss, MaterialParams.from_leaves(
        [all_reduce(g, mesh, tuple(mesh.axis_names)) for g in grads])


def train_step_sharded(params: MaterialParams, target, scene: SceneData,
                       cam: Camera, opts: RenderOptions, mesh: Mesh,
                       lr: float = 0.01, seed: int = 0):
    """One inverse-rendering SGD step distributed over ``mesh`` -> (new
    params, loss), the same on every rank: ``image_loss_and_grad_sharded``,
    then w - lr * g. Its objective is the single-device one,
    ``grad.image_loss_and_grad``'s mean((img - target)^2) over H*W*3.

    This departs from the JAX package's ``train_step_sharded``, which
    does not compute its own single-device objective (ROADMAP queue 3
    item 9): its loss divides the summed squares by n_sample * p instead
    of 3p, its gradient is that of the unnormalised sum (3p times the
    mean's), and the transpose of its ``psum`` under
    ``shard_map(check_vma=False)`` counts the gradient once per sample
    rank."""
    loss, g = image_loss_and_grad_sharded(params, target, scene, cam, opts,
                                          mesh, seed)
    new = [w.detach() - lr * d for w, d in zip(params.leaves(), g.leaves())]
    return MaterialParams.from_leaves(new), loss
