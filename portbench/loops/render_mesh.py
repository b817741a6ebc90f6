"""The render loop on a mesh: the path tracer's passes over a scene that
holds ``spd_tetra`` shapes.

The passes, the window and the check are ``loops/render.py``'s: each pass
calls ``integrators.path.render`` for ``spp_per_pass`` samples
(``samples_per_launch`` of them in one wavefront), passes run back to
back (a closed loop, as an offline render runs), and ``check_pixels``
pixels drawn from the seed are held against the plain reference
(``film_rel_l1``). What differs is the scene: the configuration's
``spd_tetra`` shapes are expanded into triangles as ``loops/bdpt.py``
expands them, and the program's scene is built under its span recorder,
so its ``tables.build`` span, where the program has one, is kept in
``info`` for ``table_build_s.mesh``.
"""
from __future__ import annotations

import time

import numpy as np

from .. import scenes
from .bdpt import scene_arrays
from .render import State, _render, _sync, check, check_pixels, unit, window

__all__ = ("setup", "unit", "window", "check", "check_pixels")


def setup(cell, seed: int, device) -> State:
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.utils import profiling
    tr, cfg = cell.traffic, cell.config
    arrays = scene_arrays(cfg)
    t = time.perf_counter()
    with profiling.recording():
        scene = scenes.build_program_scene(arrays, device)
        _sync(device)
    info = {"table_build_s": time.perf_counter() - t,
            "n_tris": scenes.n_triangles(arrays)}
    built = [s for s in profiling.recorded() if s.name == "tables.build"]
    if built:
        info["tables_build_span_s"] = built[-1].duration_ns * 1e-9
    w, h = tr["width"], tr["height"]
    cam = scenes.program_camera(cfg["camera"], w, h, device)
    ig = cfg["integrator"]
    opts = RenderOptions(spp=tr["spp_per_pass"],
                         samples_per_launch=tr["samples_per_launch"],
                         max_depth=ig["max_depth"], min_depth=ig["min_depth"],
                         mis=ig["mis"],
                         russian_roulette=ig["russian_roulette"])
    st = State(cell=cell, seed=seed, width=w, height=h,
               spp=tr["spp_per_pass"], arrays=arrays, scene=scene, cam=cam,
               opts=opts, film=np.zeros((h, w, 3), np.float64),
               first_sample=0, next_sample=0, device=device, info=info)
    # warm-up: every shape the window uses, its images not counted
    for _ in range(tr.get("warmup_passes", 1)):
        _render(st)
    st.first_sample = st.next_sample
    return st
