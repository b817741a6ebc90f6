"""Renderer orchestration: scene + camera + options -> image.

The port of ``tuturenderer_tpu/render.py``, the analogue of Renderer
(Renderer.hpp:32-72): select the integrator (path / light / naivept /
bdpt, integrateType 0-3), run it on the scene's device, and hand back the
linear framebuffer as numpy (``render_image``, ``render_config``); render
in spp chunks with a film checkpoint (``render_progressive``); the 2x2
estimator comparison (``estimator_grid``).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .options import RenderOptions
from .scene.data import SceneData
from .utils.device import DEFAULT_DEVICE


def _integrator(name: str):
    if name == "path":
        from .integrators.path import render
    elif name == "light":
        from .integrators.light import render
    elif name == "naivept":
        from .integrators.naive import render
    elif name == "bdpt":
        from .integrators.bdpt import render
    else:
        raise ValueError(f"unknown integrator {name!r}")
    return render


def render_image(scene: SceneData, cam: Camera, opts: RenderOptions,
                 integrator: str = "path", seed: int = 0,
                 postprocess: bool = False) -> np.ndarray:
    """-> linear float32 [H, W, 3] numpy, rendered on the scene's device;
    ``postprocess`` runs ``post.bloom_and_tonemap`` there first. Under
    compaction a nonzero overflow count is reported on stderr, read once
    the image is back on the host."""
    run = _integrator(integrator)
    if integrator == "path" and opts.compaction:
        img, st = run(scene, cam, opts, seed, stats=True)
        over = int(st["compaction_overflow"])
        if over > 0:
            print(f"tuturenderer_tpu_torch: compaction overflow engaged: "
                  f"{over} live lanes dropped+reweighted (unbiased); "
                  f"widen opts.compaction for lower variance",
                  file=sys.stderr)
    else:
        img = run(scene, cam, opts, seed)
    if postprocess:
        from .post import bloom_and_tonemap
        img = bloom_and_tonemap(img)
    return img.cpu().numpy()


def render_progressive(scene: SceneData, cam: Camera, opts: RenderOptions,
                       integrator: str = "path", seed: int = 0,
                       chunk_spp: int = 8,
                       checkpoint_path: Optional[str] = None,
                       resume: bool = True,
                       progress: bool = True) -> np.ndarray:
    """Render in spp chunks with optional film checkpointing -> linear
    float32 [H, W, 3] numpy.

    The reference renders all-or-nothing (its only artifact is the final
    PPM, PPMGenerator.hpp:140-160). Here the running (film sum, spp_done)
    pair is saved to ``checkpoint_path`` (``.npz``) after every chunk and
    reloaded on restart when its shape and seed match. Every integrator's
    ``render`` takes a ``sample_base`` (the RNG is keyed by the global
    sample index), so a resumed render equals an uninterrupted one up to
    float order. The light tracer checkpoints its raw accumulators (splat
    sums, the running max of the direct pane and its mask) so the
    max-combined direct pane resumes exactly. The film sums in float64 on
    the host; the file's keys and dtypes are the JAX package's, so either
    package resumes the other's checkpoint."""
    run = _integrator(integrator)
    is_light = integrator == "light"

    film = np.zeros((cam.height, cam.width, 3), np.float64)
    direct = np.zeros((cam.height, cam.width, 3), np.float64)
    dmask = np.zeros((cam.height, cam.width), bool)
    done = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["film"].shape == film.shape and int(ck["seed"]) == seed:
            film = ck["film"].astype(np.float64)
            done = int(ck["spp_done"])
            if is_light and "direct" in ck:
                direct = ck["direct"].astype(np.float64)
                dmask = ck["dmask"]
            if progress:
                print(f"resumed at {done}/{opts.spp} spp")

    while done < opts.spp:
        n = min(chunk_spp, opts.spp - done)
        chunk_opts = dataclasses.replace(opts, spp=n)
        if is_light:
            sp, dm, msk = run(scene, cam, chunk_opts, seed, done,
                              return_parts=True)
            film += sp.cpu().numpy()            # raw splat sums
            direct = np.maximum(direct, dm.cpu().numpy())
            dmask |= msk.cpu().numpy()
        else:
            film += run(scene, cam, chunk_opts, seed, done).cpu().numpy() * n
        done += n
        if checkpoint_path:
            np.savez(checkpoint_path, film=film, spp_done=done, seed=seed,
                     direct=direct, dmask=dmask)
        if progress:
            bar = int(60 * done / opts.spp)
            print("=" * bar + ">" + " " * (60 - bar) +
                  f" {int(100 * done / opts.spp)} %", flush=True)

    done = max(done, 1)
    if is_light:
        from .integrators.light import compose_light_film
        dev = scene.device
        out = compose_light_film(
            scene, cam, torch.from_numpy(film.astype(np.float32)).to(dev),
            torch.from_numpy(direct.astype(np.float32)).to(dev),
            torch.from_numpy(dmask).to(dev), done)
        return out.cpu().numpy()
    return (film / done).astype(np.float32)


def estimator_grid(scene: SceneData, cam: Camera, opts: RenderOptions,
                   seed: int = 0) -> np.ndarray:
    """2x2 estimator A/B grid: BSDF-only | light-only // NEE | NEE+MIS.

    The reference publishes this comparison as a README image grid
    (README.md:103-109) rendered from four compile-time variants; here it
    is four ``render_image`` calls. -> [2H, 2W, 3] linear float32."""
    bsdf_only = render_image(scene, cam, opts, "naivept", seed)
    light_only = render_image(scene, cam, opts, "light", seed)
    nee = render_image(scene, cam, dataclasses.replace(opts, mis=False),
                       "path", seed)
    mis = render_image(scene, cam, dataclasses.replace(opts, mis=True),
                       "path", seed)
    top = np.concatenate([bsdf_only, light_only], axis=1)
    bottom = np.concatenate([nee, mis], axis=1)
    return np.concatenate([top, bottom], axis=0)


def render_config(config_path: str, opts: Optional[RenderOptions] = None,
                  seed: int = 0, verbose: bool = True,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """Full pipeline from a reference-format config file (the equivalent of
    ``./PathTracer config.txt``, README.md:59-62): parse, build the scene
    and camera on ``device``, render with the config's integrator."""
    from .scene.config import parse_config
    t0 = time.time()
    pc = parse_config(config_path)
    scene = pc.builder.build(device=device)
    cam = pc.camera(device=device)
    if verbose:
        print(f"scene build: {time.time() - t0:.2f}s  "
              f"(tris={scene.n_tris} spheres={scene.n_spheres} "
              f"lights={scene.n_lights})")
    opts = opts or RenderOptions()
    t0 = time.time()
    img = render_image(scene, cam, opts, integrator=pc.integrator, seed=seed)
    if verbose:
        print(f"render ({pc.integrator}, {opts.spp} spp): "
              f"{time.time() - t0:.2f}s")
    return img
