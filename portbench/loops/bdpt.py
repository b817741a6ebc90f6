"""The BDPT loop: passes of the program's bidirectional path tracer.

Each pass calls ``integrators/bdpt.py``'s ``render`` (as ``render.py``
picks it for the integrator ``bdpt``) for ``spp_per_pass`` samples,
``samples_per_launch`` of them in one wavefront, advancing
``sample_base`` as a progressive render does, and adds the image to a
float64 film on the host. Passes run back to back: a closed loop, as an
offline render runs. A pass's latency runs from its call to its image on
the host.

The scene: the configuration's ``scene``, where a shape
``{"spd_tetra": {...}}`` is the SPD's Sierpinski tetrahedron
(``portbench/spd.py``), expanded here into triangles and handed with the
rest of the scene (``scenes.scene_arrays``) to the program's public scene
builder and to the plain reference. The build runs under the program's
span recorder, so its ``tables.build`` span, where the program has one,
is kept in ``info``.

The check: the image of the first counted pass, every pixel of it,
against the plain BDPT reference's film for the same sample ids
(``reference_bdpt.render_film``), by their relative L1 distance
(``film_rel_l1``: the sum of |image - reference| over the sum of
|reference|, over all pixels and the three channels). BDPT's t = 1
strategy splats light paths onto any pixel, so a pixel's value depends on
every lane, and only whole films compare.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import reference, reference_bdpt, scenes, spd, stats

OPTION_KEYS = ("bdpt_max_path_length", "tutu_bdpt_weight_kill",
               "tutu_bdpt_t1_gate", "tutu_light_pick", "tutu_tri_sample",
               "ggx_sample_bug")


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
    next_sample: int
    device: torch.device
    passes: int = 0
    nonfinite: int = 0
    first_image: Optional[np.ndarray] = None
    first_sample: int = 0         # the first counted pass's first sample id
    info: dict = dataclasses.field(default_factory=dict)


def scene_arrays(cfg: dict) -> dict:
    """The configuration's scene as ``scenes.scene_arrays`` gives it, with
    the triangles of each ``spd_tetra`` shape appended."""
    sc = cfg["scene"]
    names = [name for name, _ in sc["materials"]]
    tetra = [s for s in sc["shapes"] if "spd_tetra" in s]
    rest = dict(cfg, scene=dict(sc, shapes=[s for s in sc["shapes"]
                                            if "spd_tetra" not in s]))
    arrays = scenes.scene_arrays(rest)
    for shape in tetra:
        arrays["tris"].append((spd.tetra_triangles(shape["spd_tetra"]), None,
                               names.index(shape["material"])))
    return arrays


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
                         **{k: ig[k] for k in OPTION_KEYS})
    st = State(cell=cell, seed=seed, width=w, height=h,
               spp=tr["spp_per_pass"], arrays=arrays, scene=scene, cam=cam,
               opts=opts, film=np.zeros((h, w, 3), np.float64),
               next_sample=0, device=device, info=info)
    # warm-up: every shape the window uses, its images not counted
    for _ in range(tr.get("warmup_passes", 1)):
        _render(st)
    return st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _render(st: State) -> np.ndarray:
    from tuturenderer_tpu_torch.integrators.bdpt import render
    img = render(st.scene, st.cam, st.opts, st.seed,
                 sample_base=st.next_sample)
    st.next_sample += st.spp
    return img.cpu().numpy()


def unit(st: State) -> float:
    """One pass; returns its latency in seconds. The first counted pass's
    image is kept apart for the check."""
    first = st.next_sample
    t = time.perf_counter()
    img = _render(st)
    dt = time.perf_counter() - t
    if not np.isfinite(img).all():
        st.nonfinite += 1
    if st.first_image is None:
        st.first_image, st.first_sample = img, first
    st.film += img
    st.passes += 1
    return dt


def window(st: State, seconds: float) -> dict:
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
          f"p90 {stats.percentile(lat, 90) * 1e3:.1f}", file=sys.stderr)
    return {"values": {"mpaths_per_s": stats.rate(paths, wall) / 1e6},
            "attempted": len(lat), "failed": st.nonfinite}


def reference_film(st: State, dtype, half: bool = False) -> np.ndarray:
    """The reference's film [p, 3] over the first counted pass's sample
    ids; ``half`` over every other one, its estimates and splats taken
    over that half: half of the samples left out, the mean taken over the
    rest."""
    ref = reference.RefScene(st.arrays, st.device, dtype=dtype)
    samples = torch.arange(st.first_sample, st.first_sample + st.spp,
                           device=st.device)
    if half:
        samples = samples[::2]
    cfg = st.cell.config
    return reference_bdpt.render_film(
        ref, cfg["camera"], st.width, st.height, samples, st.seed,
        cfg["integrator"]).double().cpu().numpy()


def rel_l1(film: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(film - ref).sum() / max(np.abs(ref).sum(), 1e-30))


def check(st: State, control: bool = False, half: bool = False) -> dict:
    """-> {"film_rel_l1": value}. The program's state is freed first.
    ``control`` puts the reference in bfloat16 in the program's place;
    ``half`` the reference over half of the sample ids (the half-batch
    fault)."""
    st.scene = st.cam = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    if "reference_film" not in st.info:
        t = time.perf_counter()
        st.info["reference_film"] = reference_film(st, torch.float32)
        print(f"check: the reference's film in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    ref = st.info["reference_film"]
    if control:
        film = reference_film(st, torch.bfloat16)
    elif half:
        film = reference_film(st, torch.float32, half=True)
    else:
        film = st.first_image.reshape(-1, 3)
    return {"film_rel_l1": rel_l1(film, ref)}
