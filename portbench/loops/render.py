"""The render loop: progressive passes of the program's path tracer.

Each pass calls ``integrators.path.render`` for ``spp_per_pass`` samples
(``samples_per_launch`` of them in one wavefront), advancing
``sample_base`` as ``render.render_progressive`` does for each chunk, and
adds the image to a float64 film on the host. Passes run back to back: a
closed loop, as a progressive preview or an offline render runs. A pass's
latency runs from its call to its image on the host.

The check: a sample of ``check_pixels`` pixels, drawn from the seed, is
traced by the plain reference over every sample id the counted passes
used, and the film there is compared with the reference's sums by their
relative L1 distance (``film_rel_l1``: the sum of |film - reference| over
the sum of |reference|, over the sampled pixels and the three channels).

``traced_queries`` gives the roofline readers the live rays of each
intersection query in the traced passes.
"""
from __future__ import annotations

import dataclasses
import inspect
import sys
import time

import numpy as np
import torch

from .. import reference, scenes, stats


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    width: int
    height: int
    spp: int                      # samples a pass
    arrays: dict
    scene: object
    cam: object
    opts: object
    film: np.ndarray
    first_sample: int
    next_sample: int
    device: torch.device
    passes: int = 0
    nonfinite: int = 0
    info: dict = dataclasses.field(default_factory=dict)


def setup(cell, seed: int, device) -> State:
    from tuturenderer_tpu_torch.options import RenderOptions
    tr, cfg = cell.traffic, cell.config
    arrays = scenes.scene_arrays(cfg)
    t = time.perf_counter()
    scene = scenes.build_program_scene(arrays, device)
    _sync(device)
    info = {"table_build_s": time.perf_counter() - t,
            "n_tris": scenes.n_triangles(arrays)}
    w, h = tr["width"], tr["height"]
    cam = scenes.program_camera(cfg["camera"], w, h, device)
    ig = cfg["integrator"]
    opts = RenderOptions(spp=tr["spp_per_pass"],
                         samples_per_launch=tr["samples_per_launch"],
                         max_depth=ig["max_depth"], min_depth=ig["min_depth"],
                         mis=ig["mis"],
                         russian_roulette=ig["russian_roulette"])
    spp = tr["spp_per_pass"]
    st = State(cell=cell, seed=seed, width=w, height=h, spp=spp,
               arrays=arrays, scene=scene, cam=cam, opts=opts,
               film=np.zeros((h, w, 3), np.float64), first_sample=0,
               next_sample=0, device=device, info=info)
    # warm-up: every shape the window uses, its images not counted
    for _ in range(tr.get("warmup_passes", 1)):
        _render(st)
    st.first_sample = st.next_sample
    st.film[:] = 0.0
    st.passes = 0
    return st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _render(st: State) -> np.ndarray:
    from tuturenderer_tpu_torch.integrators.path import render
    img = render(st.scene, st.cam, st.opts, st.seed,
                 sample_base=st.next_sample)
    st.next_sample += st.spp
    return img.cpu().numpy()


def unit(st: State) -> float:
    """One pass; returns its latency in seconds."""
    t = time.perf_counter()
    img = _render(st)
    dt = time.perf_counter() - t
    if not np.isfinite(img).all():
        st.nonfinite += 1
    st.film += img
    st.passes += 1
    return dt


def window(st: State, seconds: float) -> dict:
    st.info["window_first_sample"] = st.next_sample
    lat = []
    t0 = time.perf_counter()
    while True:
        lat.append(unit(st))
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    paths = len(lat) * st.width * st.height * st.spp
    st.info.update(window_passes=len(lat), pass_latencies=lat)
    print(f"window: {len(lat)} passes in {wall:.3f} s; latency ms "
          f"p10 {stats.percentile(lat, 10) * 1e3:.1f}, "
          f"median {stats.percentile(lat, 50) * 1e3:.1f}, "
          f"p90 {stats.percentile(lat, 90) * 1e3:.1f} with "
          f"{stats.beyond(lat, 90)} beyond", file=sys.stderr)
    return {"values": {"mpaths_per_s": stats.rate(paths, wall) / 1e6,
                       "pass_p90_ms": stats.percentile(lat, 90) * 1e3},
            "attempted": len(lat), "failed": st.nonfinite}


def check_pixels(st: State) -> torch.Tensor:
    """The pixels the check traces: drawn from the seed, without
    replacement."""
    g = torch.Generator().manual_seed(st.seed)
    n = min(st.cell.traffic["check_pixels"], st.width * st.height)
    return torch.randperm(st.width * st.height, generator=g)[:n]


def reference_film(st: State, pixels, dtype, device,
                   half: bool = False) -> np.ndarray:
    """The reference's film at ``pixels``: its radiance sums over the
    counted passes' sample ids, over the samples a pass, as the program's
    film adds one image a pass. ``half`` sums every other sample id and
    scales the sums up to the whole count: half of the samples left out,
    the mean taken over the rest."""
    ref = reference.RefScene(st.arrays, device, dtype=dtype)
    samples = torch.arange(st.first_sample, st.next_sample, device=device)
    kept = samples[::2] if half else samples
    sums = reference.pixel_radiance_sum(
        ref, st.cell.config["camera"], st.width, st.height,
        pixels.to(device), kept, st.seed, st.cell.config["integrator"])
    return (sums * (len(samples) / len(kept)) / st.spp).cpu().numpy()


def rel_l1(film: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(film - ref).sum() / max(np.abs(ref).sum(), 1e-30))


def check(st: State, control: bool = False, half: bool = False) -> dict:
    """-> {"film_rel_l1": value}. The program's state is freed first.
    ``control`` puts the reference in bfloat16 in the program's place;
    ``half`` the reference over half of the sample ids (the half-batch
    fault)."""
    device = st.device
    st.scene = st.cam = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pixels = check_pixels(st)
    ref = reference_film(st, pixels, torch.float32, device)
    if control:
        film = reference_film(st, pixels, torch.bfloat16, device)
    elif half:
        film = reference_film(st, pixels, torch.float32, device, half=True)
    else:
        film = st.film.reshape(-1, 3)[pixels.numpy()]
    return {"film_rel_l1": rel_l1(film, ref)}


def traced_queries(st: State, units: int) -> dict:
    """The live rays of each intersection query of the ``units`` passes
    traced before the window, one entry a query: -> {"nearest": [rays,
    ...], "anyhit": [rays, ...]}. Those passes are rendered again with the
    same sample ids (their images dropped, the film untouched), with the
    bounce loop's two query entry points wrapped to count the lanes that
    each call's mask lets through; a call without a mask counts all its
    rays. Runs once a run, after the window."""
    if "traced_queries" in st.info:
        return st.info["traced_queries"]
    from tuturenderer_tpu_torch.integrators import path
    seen = {"nearest": [], "anyhit": []}

    def counting(kind, real):
        sig = inspect.signature(real)

        def wrapped(*args, **kw):
            bound = sig.bind(*args, **kw)
            mask = bound.arguments.get("mask")
            rays = bound.arguments["orig"].x.shape[0]
            seen[kind].append(rays if mask is None else mask.sum())
            return real(*args, **kw)
        return wrapped

    real = {"intersect_core": path.intersect_core,
            "occluded": path.occluded}
    first = st.info["window_first_sample"] - units * st.spp
    try:
        path.intersect_core = counting("nearest", real["intersect_core"])
        path.occluded = counting("anyhit", real["occluded"])
        for k in range(units):
            path.render(st.scene, st.cam, st.opts, st.seed,
                        sample_base=first + k * st.spp)
    finally:
        path.intersect_core = real["intersect_core"]
        path.occluded = real["occluded"]
    st.info["traced_queries"] = {k: [int(n) for n in v]
                                 for k, v in seen.items()}
    return st.info["traced_queries"]
