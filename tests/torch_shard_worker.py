"""The ranks of the port's multi-process sharding tests
(``tests/test_torch_sharding*.py``). Imports torch and the port only (no
jax): each rank is a fresh process started by ``spawn``.

``spawn(nprocs, meshes, out_dir)`` starts ``nprocs`` ranks with
``torch.multiprocessing`` (start method spawn, one torch thread each, a
gloo group on the CPU rendezvousing through a file under ``out_dir``); each
rank builds every mesh of ``meshes`` (the same on every rank, in the same
order), runs every case of ``CASES`` on it, and saves what it got to
``out_dir/rank<r>.npz`` under ``<mesh>/<case>/<key>``."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

SIZE = (24, 20)         # REF_SIZE of torch_port_util
SEED = 3
LR = 0.05
# case -> (RenderOptions fields, simple_box keywords)
CASES = {
    "path": ({"spp": 4}, {}),
    "path-bvh": ({"spp": 4, "max_depth": 3}, {"use_bvh": True}),
    "light": ({"spp": 4}, {}),
    "bdpt": ({"spp": 4, "bdpt_max_path_length": 3}, {}),
    "train": ({"spp": 2, "max_depth": 2}, {}),
}


def scene_of(case: str):
    from tuturenderer_tpu_torch.scene.presets import simple_box
    return simple_box(*SIZE, device="cpu", **CASES[case][1])


def options_of(case: str):
    from tuturenderer_tpu_torch.options import RenderOptions
    return RenderOptions(**CASES[case][0])


def train_target(cam) -> torch.Tensor:
    """A fixed target image for the training step (seeded noise)."""
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.uniform(0.0, 0.5, (cam.height, cam.width, 3))
                            .astype(np.float32))


def make(kind: str):
    """The mesh of a name: "make_mesh" (the factoring rule), "1x2"
    (tile 1 x sample 2), "hosts" (make_multihost_mesh(force_hosts=2))."""
    from tuturenderer_tpu_torch.parallel import distributed as D
    from tuturenderer_tpu_torch.parallel.sharding import make_mesh
    if kind == "make_mesh":
        return make_mesh()
    if kind == "1x2":
        return D.new_mesh(("tile", "sample"), (1, 2))
    if kind == "hosts":
        return D.make_multihost_mesh(force_hosts=2)
    raise ValueError(kind)


def run_case(case: str, mesh) -> dict:
    from tuturenderer_tpu_torch.grad import get_params
    from tuturenderer_tpu_torch.parallel import sharding as S
    scene, cam = scene_of(case)
    opts = options_of(case)
    if case == "train":
        params, target = get_params(scene), train_target(cam)
        loss, g = S.image_loss_and_grad_sharded(params, target, scene, cam,
                                                opts, mesh, seed=SEED)
        new, step_loss = S.train_step_sharded(params, target, scene, cam,
                                              opts, mesh, lr=LR, seed=SEED)
        out = {"loss": loss.numpy(), "step_loss": step_loss.numpy()}
        out.update({f"grad{i}": a.numpy() for i, a in enumerate(g.leaves())})
        out.update({f"new{i}": a.numpy() for i, a in enumerate(new.leaves())})
        return out
    run = {"path": S.render_sharded, "path-bvh": S.render_sharded,
           "light": S.render_light_sharded,
           "bdpt": S.render_bdpt_sharded}[case]
    return {"image": run(scene, cam, opts, mesh, seed=SEED).numpy()}


def rank_main(rank: int, nprocs: int, meshes, out_dir: str):
    torch.set_num_threads(1)
    from tuturenderer_tpu_torch.parallel import distributed as D
    D.init_distributed(f"file://{os.path.join(out_dir, 'rendezvous')}",
                       nprocs, rank)
    assert D.dist.get_backend() == "gloo"
    out = {}
    for kind in meshes:
        mesh = make(kind)
        out[f"{kind}/shape"] = np.asarray(
            [mesh.shape[a] for a in mesh.axis_names])
        out[f"{kind}/axes"] = np.asarray(",".join(mesh.axis_names))
        for case in CASES:
            for key, val in run_case(case, mesh).items():
                out[f"{kind}/{case}/{key}"] = val
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    D.dist.destroy_process_group()


def spawn(nprocs: int, meshes, out_dir: str, timeout: float = 240.0):
    """Run ``rank_main`` on ``nprocs`` ranks; -> each rank's saved dict."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(rank_main, args=(nprocs, tuple(meshes), out_dir),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(nprocs)]


def single_device(case: str) -> dict:
    """What the port computes for ``case`` on one device."""
    from tuturenderer_tpu_torch.grad import get_params, image_loss_and_grad
    from tuturenderer_tpu_torch.integrators import bdpt, light, path
    scene, cam = scene_of(case)
    opts = options_of(case)
    if case == "train":
        params = get_params(scene)
        loss, g = image_loss_and_grad(params, train_target(cam), scene, cam,
                                      opts, seed=SEED)
        out = {"loss": loss.numpy()}
        out.update({f"grad{i}": a.numpy() for i, a in enumerate(g.leaves())})
        out.update({f"new{i}": (w - LR * d).numpy() for i, (w, d) in
                    enumerate(zip(params.leaves(), g.leaves()))})
        return out
    run = {"path": path.render, "path-bvh": path.render,
           "light": light.render, "bdpt": bdpt.render}[case]
    return {"image": run(scene, cam, opts, seed=SEED).numpy()}
