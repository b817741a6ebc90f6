"""Renderer orchestration: scene + camera + options -> image.

The port of ``tuturenderer_tpu/render.py``'s ``render_image`` and
``render_config``, the analogue of Renderer (Renderer.hpp:32-72): select
the integrator (path / light / naivept / bdpt, integrateType 0-3), run it
on the scene's device, and hand back the linear framebuffer as numpy.

Not served yet: ``postprocess`` (bloom and tone mapping) raises
``NotImplementedError`` naming ROADMAP queue 1 item 13b.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

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
    """-> linear float32 [H, W, 3] numpy, rendered on the scene's device.
    Under compaction a nonzero overflow count is reported on stderr, read
    once the image is back on the host."""
    run = _integrator(integrator)
    if postprocess:
        raise NotImplementedError(
            "postprocess (bloom and tone mapping) comes with ROADMAP queue 1 "
            "item 13b")
    if integrator == "path" and opts.compaction:
        img, st = run(scene, cam, opts, seed, stats=True)
        img = img.cpu().numpy()
        over = int(st["compaction_overflow"])
        if over > 0:
            print(f"tuturenderer_tpu_torch: compaction overflow engaged: "
                  f"{over} live lanes dropped+reweighted (unbiased); "
                  f"widen opts.compaction for lower variance",
                  file=sys.stderr)
        return img
    return run(scene, cam, opts, seed).cpu().numpy()


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
