"""Process bootstrap, meshes of ranks and the collectives over them.

The port of ``tuturenderer_tpu/parallel/distributed.py`` to
``torch.distributed``. The reference has no multi-process backend at all
(SURVEY.md section 2: threads and mutexes only). Here one process drives
one card (a rank); ``Mesh`` lays the ranks out on named axes, ``("tile",
"sample")`` or, across hosts, ``("host", "tile", "sample")``, and holds one
process group for each set of axes the renderers reduce over: the
``sample`` axis, the pixel axes (every axis but ``sample``) and all of
them.

Usage, the same code in one process and under ``torchrun``:

    from tuturenderer_tpu_torch.parallel import distributed as dist
    dist.init_distributed()            # nothing to do in a single process
    mesh = dist.make_multihost_mesh()
    img = render_sharded(scene, cam, opts, mesh)

Without an initialized process group a mesh has one rank, and its
collectives return their input.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the default process group.

    The arguments fall back to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. ``coordinator_address``
    is ``host:port`` (TCP) or an init-method URL such as ``file:///...``.
    The backend is NCCL when each rank of this host has a card of its own
    (``LOCAL_WORLD_SIZE``, else all ``num_processes``, ranks per host), and
    the rank then takes card ``LOCAL_RANK`` (else its rank); gloo
    otherwise. Nothing is done in a single process or when a group is
    already initialized."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator address")
        return
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = int(env.get("LOCAL_RANK", process_id % local_ranks))
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_ranks:
        backend = "nccl"
        torch.cuda.set_device(local_rank)
    else:
        backend = "gloo"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a mesh of ranks laid out row-major over
    ``axis_names`` with sizes ``shape``, and the process groups of the
    rank's collectives: ``groups[axes]`` holds the ranks that share this
    rank's coordinates on every axis not in ``axes`` (None without an
    initialized process group)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]]
    backend: Optional[str]


def pixel_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a flat pixel/lane array shards over (every axis but
    'sample')."""
    return tuple(a for a in mesh.axis_names if a != "sample")


def reduce_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All mesh axis names (a full reduction of gradients/losses)."""
    return tuple(mesh.axis_names)


def new_mesh(axis_names, sizes) -> Mesh:
    """The mesh of the default group's ranks on ``axis_names`` (sizes
    ``sizes``, whose product is the world size), with a process group for
    the sample axis, the pixel axes and all axes. ``new_group`` is
    collective: every rank calls this with the same arguments, and creates
    every group, its own or not, in the same order."""
    axis_names = tuple(axis_names)
    sizes = tuple(int(n) for n in sizes)
    shape = dict(zip(axis_names, sizes))
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {shape} needs {int(np.prod(sizes))} ranks, "
                         f"the world has {world}")
    rank = dist.get_rank() if on else 0
    layout = np.arange(world).reshape(sizes)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
        rank, sizes))))
    pix = tuple(a for a in axis_names if a != "sample")
    groups: Dict[Tuple[str, ...], Optional[dist.ProcessGroup]] = {}
    for axes in (("sample",), pix, axis_names):
        if axes in groups:
            continue
        groups[axes] = None
        if not on:
            continue
        # the axes kept fixed go first: each row of ``ranks`` is one group
        kept = [i for i, a in enumerate(axis_names) if a not in axes]
        moved = [axis_names.index(a) for a in axes]
        ranks = layout.transpose(kept + moved).reshape(
            -1, int(np.prod([shape[a] for a in axes])))
        for row in ranks:
            group = dist.new_group(row.tolist())
            if rank in row:
                groups[axes] = group
    return Mesh(axis_names, shape, coords, groups,
                dist.get_backend() if on else None)


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    # gloo runs its collectives on host memory and takes a CUDA tensor for
    # few of them (all_reduce and broadcast only), so under gloo every
    # collective on a card's tensor goes through a host copy here
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, mesh: Mesh, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced (``op``) over the ranks of ``mesh.groups[axes]``; a
    new tensor on ``t``'s device."""
    group = mesh.groups[tuple(axes)]
    if group is None:
        return t.clone()
    # collectives take contiguous tensors only
    t = t.contiguous()
    work = t.cpu() if _staged(t, mesh) else t.clone()
    dist.all_reduce(work, op=op, group=group)
    return work.to(t.device)


def all_gather(t: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The ``t`` of every rank of ``mesh.groups[axes]``, concatenated
    along dim 0 in rank order, on ``t``'s device."""
    group = mesh.groups[tuple(axes)]
    if group is None:
        return t.clone()
    t = t.contiguous()
    work = t.cpu() if _staged(t, mesh) else t
    parts = [torch.empty_like(work) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, work, group=group)
    return torch.cat(parts).to(t.device)


def make_multihost_mesh(sample: Optional[int] = None,
                        force_hosts: Optional[int] = None) -> Mesh:
    """("host", "tile", "sample") mesh: ``host`` spans the hosts,
    ``tile``/``sample`` the ranks within each host.

    The hosts are counted as world size / ``LOCAL_WORLD_SIZE`` (torchrun's
    ranks per host; one host without it). ``force_hosts`` partitions the
    ranks into this many host rows instead (a one-host test of the
    host-shaped axis: the collectives run exactly as they would across
    hosts; only the transport differs)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_hosts = force_hosts or max(
        1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    per_host = world // n_hosts
    if sample is None:
        sample = 1
        for cand in (4, 2):
            if per_host % cand == 0 and per_host // cand >= 1:
                sample = cand
                break
    tile = per_host // sample
    return new_mesh(("host", "tile", "sample"), (n_hosts, tile, sample))
