#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and nvcc.
Phases, in order; any failure raises and the script exits non-zero:

1. device: name, power limit, torch and CUDA versions;
2. build: nvcc compiles ``tuturenderer_tpu_torch/csrc/dense_intersect.cu``
   (K1-K4), ``bvh_walk.cu`` (K5-K7), ``proto_visit.cu`` (K8) and
   ``rng.cu`` (the RNG's draw) and ``bsdf.cu`` (the BSDF's three calls),
   one process each, started together, with each kernel's registers,
   stack frame and spills;
3. each dense intersection kernel, in the Woop form (K1, K2) and the
   Moller-Trumbore form (K3, K4), against its plain PyTorch version on the
   card: simple_box's 12 triangles at 1,048,576 rays, the first 100,001 of
   them (a ragged count: odd, and no multiple of a block), a 4095-triangle
   soup at 65,536 rays, rays aimed at shared edges and vertices, and
   shadow distances at 0.5x, 1x, 2x and within 1e-4 of the hit distance;
   with the device time and the bound of each (``utils/timing.py``: CUDA
   events around back-to-back calls, the stream held while the host
   enqueues them), at simple_box and at the soup; then the tiled kernels'
   ragged edges (1 to 1,001 rays against soups of 1 to 4,095 triangles)
   and a block-exit set for both any hits, K2 and K4 (rays blocked in the
   first tile, never blocked, and mixed, by whole blocks), each timed
   there;
4. the dense slice: ``render(simple_box(1024, 1024), RenderOptions(spp=64))``
   on the card, timed by ``utils/profiling.py``'s ``measure_render``, with
   the kernel launch counts of that run; the RNG kernel's launches of that
   run held to the ``rng`` spans of the same render run again under the
   span recorder, one a span, every number drawn by the kernel; the BSDF
   kernels' launches held to 2 evals, 1 sample and 2 pdfs a bounce;
5. the render at the size of the stored JAX reference image
   (``tests/data/torch_simple_box_jax_ref.npy``) against that image;
6. each cluster kernel, the three modes of the BVH walk of
   ``bvh_walk.cu`` (K5 nearest hit, K6 any hit, K7 transmittance), against
   the plain versions: sphere_showcase (100,356 triangles) at 65,536 camera
   and random bounce rays, terrain (1,048,354 triangles) at 16,384, and the
   bounce wavefronts of 262,144 rays taken from a 1-spp render of each
   (terrain's held to the plain versions on every 4th ray); the same
   shadow distances, and for K7 a table whose alphas are drawn from
   {0.3, 0.85, 1.0}; the BVH build seconds; at each wavefront, the device
   time of K5, K6 and K7 in turns, ray/triangle tests and node visits per
   ray and the bound, and each kernel on each 8,192-ray slice of the
   wavefront alone; at the showcase wavefront the plain versions' time,
   and each kernel under the profiler's CUDA trace beside the event timer,
   with the kernel records the trace kept;
7. the mesh-scale slice: ``render(sphere_showcase(512, 512),
   RenderOptions(spp=16))``, ``terrain(512, 512, nx=724, nz=724)`` at 4 spp
   and the translucent showcase (the sphere at alpha 0.5) at 256^2 x 4 spp
   with ``alpha_shadows``, each with its exact launch counts;
8. the mesh-scale renders against the stored JAX references
   (``tests/data/torch_*_jax_ref.npz``, made by
   ``tests/data/make_torch_mesh_refs.py``), each rendered as its file's
   ``case`` says;
9. the dense training path: forward and backward of
   ``mean(render_diff(simple_box(1024, 1024)))`` at 8 spp under the MT
   form (K3/K4), with exact launch counts, finite gradients, a central
   finite difference of the red wall's diffuse red channel, rays/s and the
   peak device memory at 2 and at 8 spp;
10. the mesh-scale training path: the same for ``sphere_showcase(256,
    256)`` at 8 spp through K5/K6, on the sphere's diffuse red channel;
11. a few steps of the inverse-rendering loop (``grad.invert_materials``)
    on simple_box from a wrong red-wall albedo;
12. the card's images and gradients against the stored JAX gradients
    (``tests/data/torch_grad_*_jax_ref.npz``, made by
    ``tests/data/make_torch_grad_refs.py``), each computed as its file's
    ``case`` says;
13. the visit-walk probe (K8): ``tools/proto_visit.py``'s ``main`` (its two
    scenarios at 1,024 clusters and 64 tiles), then each scenario and the
    special planes (``proto_visit.special_planes``), with and without dead
    lanes and at 3 tiles, against the plain version, with the device time
    of its launch alone (the full walk and the early exit) and of ``run``
    with its synchronising input check, the SMs the launch occupies and
    its warp-instruction slots per plane test at the SM clock under load;
14. the config entry point: ``render.render_config`` of
    ``golden/mft_128.txt`` and ``golden/tex_128.txt`` (a copy whose
    texture paths point at this checkout's ``golden/tex/``) at 128x128 x
    64 spp in one wavefront, under the oracle quirk profile, at seeds 9
    and 23, quantized with the reference's truncating write and held to
    the reference renderer's images (``golden/*_ref.ppm``) with
    tests/test_golden.py's ``compare`` and bars; K1 and K2 against their
    plain versions on the first bounce's nearest hits and NEE shadow rays
    of each config's render; a ``write_ppm`` ->
    ``read_ppm`` round trip under ``build/chip_smoke/``; and
    ``golden/mesh_bdpt_128.txt`` (18,244 faces) parsed and built with
    cluster tables, with its seconds;
15. wavefront compaction: ``sphere_showcase(512, 512)`` x 16 spp in one
    wavefront under the schedule bench.py derives from the live-lane
    fractions (1.5x, floor 0.01), compacted and uncompacted in turns,
    equal to float order, with K5 and K6 against their plain versions on
    that render's 4,194,304-lane wavefront and its first compacted width;
    ``simple_box(256, 256)`` x 16 spp whose compaction (1.0, 0.25)
    overflows (the mean within 5 %) and (1.0, 1.0) does not, with K1 and
    K2 on the shrunk wavefront; the translucent showcase under
    ``alpha_shadows`` and a schedule that must not overflow, equal to the
    uncompacted render, with K5 and K7 on its shrunk wavefront; and two
    compacted renders against the stored JAX renders
    (``tests/data/torch_compact_*_jax_ref.npz``), the overflow count
    equal;
16. the light tracer and the naive path tracer on ``simple_box(1024,
    1024)`` and ``sphere_showcase(512, 512)`` at 16 spp, walls and
    Mpaths/s, the kernels (K1/K2, K5/K6) against their plain versions on
    each walk's nearest hits and the light tracer's direct and connection
    shadow rays, the CHECK_LT pass (``raster_check``,
    ``raster_roundtrip_error``), and four renders against the stored JAX
    renders (``tests/data/torch_{lt,naive}_*_jax_ref.npz``, made by
    ``tests/data/make_torch_integrator_refs.py``);
17. BDPT (``integrators/bdpt.py``) on ``simple_box(1024, 1024)`` (K1/K2)
    and ``sphere_showcase(512, 512)`` (K5/K6) at 16 spp and the default
    bdpt_max_path_length 7: walls, Mpaths/s, peak device memory and the
    launches (13 nearest hits and 1 any hit a wavefront), one wavefront's
    device busy share under the profiler, the kernels against their plain
    versions on a wavefront's eye and light walk and its single shadow
    call over the 27 strategies' connection rays (28,311,552 rays on
    both routes);
18. ``render_config`` of ``golden/mesh_bdpt_128.txt`` (18,244 faces, BDPT
    through K5/K6) at 128x128 x 64 spp under the oracle quirk profile,
    seeds 9 and 23, held to ``golden/mesh_bdpt_128_ref.ppm`` with
    tests/test_golden.py's ``compare`` at its bars for that config;
19. four BDPT renders against the stored JAX renders
    (``tests/data/torch_bdpt_*_jax_ref.npz``), one at the default
    bdpt_max_path_length 7;
20. forward and backward of ``mean(grad.render_light_diff(simple_box(1024,
    1024)))`` at 2 and 8 spp and of ``mean(grad.render_bdpt_diff(
    simple_box(512, 512)))`` at 1 and 4 spp: exact launches, finite
    gradients, the peak device memory flat in spp, a central finite
    difference of the red wall's diffuse red channel, K1/K2 against their
    plain versions on one forward sample of render_bdpt_diff; then both
    against the stored JAX gradients (``tests/data/torch_grad_{lt,bdpt}_diffuse_
    jax_ref.npz``).
21. the shell, ``cli.main`` called in this process as ``python -m
    tuturenderer_tpu_torch`` would call it: ``golden/mft_128.txt``,
    ``tex_128.txt`` (relocated) and ``mesh_bdpt_128.txt`` (BDPT through
    K5/K6) at 128x128 x 64 spp, each PPM held to ``render_config``'s image
    under the same options through the same write (within one 8-bit level,
    equal on >= 99.9 %); ``--checkpoint`` at 32 spp, then resumed to 64 in
    16-spp chunks, for each integrator on mft_128, held to the single-shot
    ``render_image`` (rtol 2e-4, atol 2e-6); ``--estimator-grid``, each
    pane against its own ``render_image``; ``--post`` against
    tests/test_post.py's float64 ``ref_pipeline`` of the unprocessed render
    (rtol 2e-4, atol 1e-6), its PPM against that pass's write;
    ``--profile --trace-dir build/chip_smoke/trace``, the
    trace holding records of each kernel the render launched; ``--invert``
    on tests/test_cli.py's INVERT_CONFIG at 128x128, 40 steps, the loss
    below 0.05 of its first;
22. multi-GPU (``parallel/sharding.py``) in an NCCL group of world 1 in
    this process: ``render_sharded`` of simple_box 1024^2 x 64 spp against
    phase 4's render (rtol 2e-5, atol 2e-6, tests/test_sharding.py's bar),
    ``render_light_sharded`` and ``render_bdpt_sharded`` at simple_box
    1024^2 x 16 spp, ``render_sharded`` of sphere_showcase 512^2 x 16 (K5/
    K6) and of the translucent showcase 256^2 x 4 under ``alpha_shadows``
    (K7) against phases 7 and 17; K1/K2 and K5/K6 against their plain
    versions on a sharded render's inputs; ``train_step_sharded`` at
    simple_box 1024^2 x 8 spp and ``image_loss_and_grad_sharded`` at 2 spp
    under the MT form (K3/K4) against ``grad.image_loss_and_grad`` (the
    gradients within 1e-5 of each leaf's largest magnitude, the step equal
    to w - lr g), the peak device memory the same at 2 and 8 spp; then two
    spawned ranks on the one card in a gloo group (NCCL takes one rank a
    device), simple_box 256^2 x 16 spp as tile 2 x sample 1 and tile 1 x
    sample 2, each rank's image against the single-device render;
23. ``ops/intersect.py::intersect_scene`` (``shade_hit`` of
    ``intersect_core``) on simple_box 1024^2's 1,048,576 primary rays
    through K1, again through K3 under the MT form, and on
    sphere_showcase 512^2's 262,144 through K5, one launch each, every
    HitRecord field held to the same call routed through the kernels'
    plain versions (t bit-equal, idx equal where t is unique: a differing
    idx must be an exact t tie, both triangles accepting the ray at that
    t; every other field bit-equal where idx is); the device time of
    ``intersect_scene`` against ``intersect_core`` alone (``utils/
    timing.py``), so the share of ``shade_hit``'s gathers is on record;
    and phase 4's render under ``utils/profiling.py``: the
    ``measure_render`` that timed it and ``rays_per_path`` at every lane
    alive and at the live fractions measured there;
24. the RNG kernel (``csrc/rng.cu``) against the plain hash at 1,048,576
    and 4,194,304 lanes, as the path tracer draws (seed and bounce word
    Python ints, lane and sample int32 columns): every purpose bit-equal,
    one launch a draw, and the device time of a draw beside its bound by
    bytes and the plain hash's time a draw. The kernels line gives it phase
    4's launches and the largest difference from the plain hash seen here;
25. the BSDF kernels (``csrc/bsdf.cu``) against the plain versions
    (``materials.py``'s ``*_plain``) at 1,048,576 and 4,194,304 lanes of
    every material type: each call bit-equal with its flags on and off,
    one launch a call, and the device time of each call beside its bound
    by bytes and the plain version's time. The kernels line gives each
    phase 4's launches.

Every render of phases 14-22 is timed and its kernel launches are held to
the count its log line's formula gives. Their kernel comparisons run on the
inputs the render gave the kernel (``tools/time_kernels.py``'s
``capture``, in one more render that is not timed, at the render's own
wavefront width), the cluster plain versions on at most 65,536 of each
call's rays, the dense ones on every ray, and their errors join the kernels
line's ``max_abs_err``.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits with code 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REF_IMAGE = "tests/data/torch_simple_box_jax_ref.npy"
REF_SIZE, REF_SPP, REF_SEED = (24, 20), 4, 3   # how the reference was made
DENSE_SRC = "tuturenderer_tpu_torch/csrc/dense_intersect.cu"
BVH_SRC = "tuturenderer_tpu_torch/csrc/bvh_walk.cu"
SOURCES = {"nearest": DENSE_SRC, "anyhit": DENSE_SRC,
           "mt_nearest": DENSE_SRC, "mt_anyhit": DENSE_SRC,
           "cluster_nearest": BVH_SRC, "cluster_anyhit": BVH_SRC,
           "cluster_transmit": BVH_SRC,
           "proto_visit": "tuturenderer_tpu_torch/csrc/proto_visit.cu"}
REPLACES = {"nearest": "tuturenderer_tpu/ops/pallas/intersect.py:164",
            "anyhit": "tuturenderer_tpu/ops/pallas/intersect.py:218",
            "mt_nearest": "tuturenderer_tpu/ops/pallas/intersect.py:41",
            "mt_anyhit": "tuturenderer_tpu/ops/pallas/intersect.py:246",
            "cluster_nearest": "tuturenderer_tpu/ops/pallas/cluster.py:509",
            "cluster_anyhit": "tuturenderer_tpu/ops/pallas/cluster.py:518",
            "cluster_transmit": "tuturenderer_tpu/ops/pallas/cluster.py:526",
            "proto_visit": "tools/proto_visit.py:27"}
KERNEL_NAMES = {"nearest": "woop_nearest", "anyhit": "woop_anyhit",
                "mt_nearest": "mt_nearest", "mt_anyhit": "mt_anyhit",
                "cluster_nearest": "cluster_nearest",
                "cluster_anyhit": "cluster_anyhit",
                "cluster_transmit": "cluster_transmit",
                "proto_visit": "visit_walk"}
# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): HBM bytes/s and
# fp32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
FLOP_PER_TEST = 30      # one Woop ray/triangle test: ~30 fp32 operations
FLOP_PER_NODE = 40      # one BVH node visit: two slab tests of ~20
FLOP_PER_MT_TEST = 55   # one Moller-Trumbore test (ops/pallas/intersect.py:146)
FLOP_PER_PLANE = 12     # one K8 plane test: 6 mul, 5 add, 1 div
SHADOW_DISTS = ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                (1.0, -5e-5), (1.0, 2e-4), (1.0, -2e-4))
# the stored JAX references each phase holds the card to, by name: each
# ``tests/data/torch_<name>_jax_ref.npz`` says under ``case`` how it was
# made (tests/data/make_torch_{mesh,grad,integrator}_refs.py), and the
# card's run is made as the file says
MESH_NAMES = ("showcase-mis", "showcase-nee", "translucent-alpha",
              "box-nee", "box-alpha")
GRAD_NAMES = ("diffuse-mis", "ggx-nee")
GRAD_LEAVES = ("diffuse.x", "diffuse.y", "diffuse.z", "emission.x",
               "emission.y", "emission.z", "roughness", "metallic")

def log(msg: str):
    print(msg, flush=True)


def wall_ms(fn, reps: int = 20) -> float:
    """Median of CUDA-event times around single calls, host launch
    overhead included."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiler_ms(fn, kernel: str, reps: int = 20, warm: int = 3):
    """(mean ms per kernel record, records kept, records expected) of the
    kernels whose name holds ``kernel``, from the profiler's CUDA trace
    around ``reps`` calls that launch one such kernel each, read beside
    ``utils/timing.py``'s. The mean per record holds when the trace drops
    records; a sum over the records divided by the calls would not."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key]
    kept = sum(e.count for e in ev)
    us = sum(e.self_device_time_total for e in ev)
    return us / max(kept, 1) / 1e3, kept, reps


def random_unit(n: int, gen: torch.Generator, device) -> torch.Tensor:
    d = torch.randn((n, 3), generator=gen, device=device)
    return d / d.norm(dim=1, keepdim=True)


def cols(a: torch.Tensor):
    return [a[:, i].contiguous() for i in range(3)]


def edge_rays(scene, eye: torch.Tensor, device):
    """Rays from the eye through vertices and points along every triangle
    edge, shared edges (the quads' diagonals) included."""
    verts = torch.stack([torch.stack(list(v), dim=1)
                         for v in (scene.tv0, scene.tv1, scene.tv2)], dim=1)
    s = torch.linspace(0.0, 1.0, 65, device=device)[None, :, None]
    pts = []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        pa, pb = verts[:, a][:, None, :], verts[:, b][:, None, :]
        pts.append((pa + s * (pb - pa)).reshape(-1, 3))
    pts = torch.cat(pts)
    d = pts - eye[None, :]
    d = d / d.norm(dim=1, keepdim=True)
    return eye[None, :].expand_as(d).contiguous(), d


def dense_form(form: str) -> dict:
    """The dense kernels of one form: their LAUNCHES keys, table packer,
    wrappers and plain versions, the plain per-triangle test, the table
    row width, the fp32 operations per test and the TPU kernels' names."""
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    if form == "woop":
        return dict(keys=("nearest", "anyhit"), pack=K.pack_triangles_woop,
                    near=K.tri_intersect, near_plain=K.tri_intersect_plain,
                    occ=K.tri_occluded, occ_plain=K.tri_occluded_plain,
                    tile=K._woop_tile, floats=K.TRI_FLOATS,
                    flop=FLOP_PER_TEST, labels=("K1", "K2"))
    return dict(keys=("mt_nearest", "mt_anyhit"), pack=K.pack_triangles,
                near=K.tri_intersect_mt, near_plain=K.tri_intersect_mt_plain,
                occ=K.tri_occluded_mt, occ_plain=K.tri_occluded_mt_plain,
                tile=K._mt_tile, floats=K.MT_FLOATS, flop=FLOP_PER_MT_TEST,
                labels=("K3", "K4"))


# the dense plain versions trace at most this many rays a call: BDPT's
# single shadow call holds 27 x 1,048,576 rays at full width
DENSE_PLAIN_RAYS = 1 << 22


def by_slices(plain, table, cols):
    """A dense plain version over consecutive slices of at most
    DENSE_PLAIN_RAYS rays of ``cols``, its outputs joined."""
    outs = [plain(table, *(c[lo:lo + DENSE_PLAIN_RAYS] for c in cols))
            for lo in range(0, cols[0].shape[0], DENSE_PLAIN_RAYS)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def compare_kernels(name: str, form: str, scene, rays, report: dict,
                    timed: bool = True, quiet: bool = False, shadows=None,
                    table=None):
    """Kernel vs plain on one ray set, nearest hit and any hit, in one
    dense form: hits equal, t and the barycentrics bit-equal, idx equal
    wherever t is unique, every any-hit mask equal. The any hits run at
    distances from the hit (SHADOW_DISTS), or on ``shadows`` ({label: 6
    ray columns + dist}) when given. ``table`` replaces the scene's packed
    triangles. Both trace every ray, the plain versions on consecutive
    slices of at most DENSE_PLAIN_RAYS (``by_slices``). Returns the kernel
    and plain device times (ms), or {} when not ``timed``. ``quiet`` logs
    nothing unless a comparison fails."""
    from tuturenderer_tpu_torch.utils.timing import device_ms
    say = (lambda msg: None) if quiet else log
    f = dense_form(form)
    k_near, k_occ = f["keys"]
    if table is None:
        table = f["pack"](scene)
    name = f"{name} [{'/'.join(f['labels'])}]"
    tk, ik, uk, vk = f["near"](table, *rays)
    tp, ip, up, vp = by_slices(f["near_plain"], table, rays)
    torch.cuda.synchronize()
    hk, hp = ik >= 0, ip >= 0
    n_split = int((hk != hp).sum())
    both = hk & hp
    t_err = (tk - tp)[both].abs().max().item() if both.any() else 0.0
    # the kernel and the plain version both keep the lowest index on an
    # exact t tie, so every idx must agree; a differing idx would have to
    # be a tie
    idx_diff = both & (ik != ip)
    same = both & (ik == ip)
    uv_err = max((uk - up)[same].abs().max().item(),
                 (vk - vp)[same].abs().max().item()) if same.any() else 0.0
    say(f"  {name}: nearest rays={rays[0].shape[0]} "
        f"hit={hp.float().mean().item():.4f} hit/miss disagree={n_split} "
        f"max|dt|={t_err:.3g} idx differs={int(idx_diff.sum())} "
        f"max|du|,|dv|={uv_err:.3g}")
    if n_split:
        raise AssertionError(f"{name}: hit/miss disagree on {n_split} rays")
    if t_err:
        raise AssertionError(f"{name}: t differs by {t_err}")
    if bool((tk[idx_diff] != tp[idx_diff]).any()):
        raise AssertionError(f"{name}: idx differs where t is unique")
    if uv_err:
        raise AssertionError(f"{name}: barycentrics differ by {uv_err}")
    err = max(t_err, uv_err)
    report[k_near] = max(report.get(k_near, 0.0), err)

    # shadow rays: dist at 0.5x, 1x, 2x and within 1e-4 of the hit
    t_ref = torch.where(hp, tp, torch.full_like(tp, 10.0))
    if shadows is None:
        shadows = {f"t*{fac}{off:+g}": [*rays, (t_ref * fac + off)
                                       .contiguous()]
                   for fac, off in SHADOW_DISTS}
    any_err = 0.0
    for label, cols in shadows.items():
        bk = f["occ"](table, *cols)
        bp = by_slices(f["occ_plain"], table, cols)
        n_diff = int((bk != bp).sum())
        any_err = max(any_err, float(n_diff > 0))
        say(f"  {name}: any-hit dist={label} rays={cols[0].shape[0]} "
            f"blocked={bp.float().mean().item():.4f} disagree={n_diff}")
        if n_diff:
            raise AssertionError(f"{name}: any-hit disagrees on {n_diff} rays")
    report[k_occ] = max(report.get(k_occ, 0.0), any_err)
    if not timed:
        return {}

    dist = (t_ref * 2.0).contiguous()
    calls = {k_near: lambda: f["near"](table, *rays),
             k_near + "_plain": lambda: f["near_plain"](table, *rays),
             k_occ: lambda: f["occ"](table, *rays, dist),
             k_occ + "_plain": lambda: f["occ_plain"](table, *rays, dist)}
    # the plain versions launch thousands of ops per call, more than the
    # launch queue holds behind a spin: they run unheld (device-bound)
    ms = {k: device_ms(fn, hold_ms=0 if k.endswith("_plain") else 50.0)
          for k, fn in calls.items()}
    wall = {k: wall_ms(fn) for k, fn in calls.items()}
    for k in (k_near, k_occ):
        log(f"  {name}: {k} device ms kernel={ms[k]:.4f} "
            f"plain={ms[k + '_plain']:.4f}; per call with launch overhead "
            f"kernel={wall[k]:.4f} plain={wall[k + '_plain']:.4f}")
    return ms


def phase_device():
    log("== phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name


def phase_build():
    log("== phase 2: build")
    from tuturenderer_tpu_torch.ops.cuda import build
    names = ("dense_intersect", "bvh_walk", "proto_visit", "rng", "bsdf")
    t0 = time.perf_counter()
    build.load_all(names)
    secs = time.perf_counter() - t0
    for name in names:
        if name not in build.BUILD_LOG:
            log(f"library already built: {build.library_path(name)}")
            continue
        nvcc_s, out = build.BUILD_LOG[name]
        log(f"nvcc {' '.join(build.NVCC_FLAGS)} {name}.cu: built in "
            f"{nvcc_s:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {line.strip()}")
    log(f"build and load, all sources: {secs:.2f} s")


def phase_kernels(dev):
    log("== phase 3: dense kernels vs plain on the card, Woop (K1/K2) and "
        "Moller-Trumbore (K3/K4)")
    from tuturenderer_tpu_torch.tools.time_kernels import dense_sets
    report, times, bounds = {}, {}, {}

    # simple_box: 2^19 camera rays (a checkerboard of the 1024^2 frame) and
    # 2^19 bounce rays from random points inside the box; a 4095-triangle
    # soup at 65,536 rays; rays at shared edges and vertices
    sets = dense_sets(dev)
    scene, cam, rays = sets["simple_box 1M"]
    soup, _, soup_rays = sets["soup 4095 x 65536"]
    assert rays[0].shape[0] == 1 << 20
    oe, de = edge_rays(scene, torch.stack(list(cam.position)).to(dev), dev)
    edges = cols(oe) + cols(de)

    # a ragged count: odd, and no multiple of a block of rays
    ragged = 100001
    for form in ("woop", "mt"):
        times.update(compare_kernels("simple_box 12 tris", form, scene, rays,
                                     report))
        bounds.update(dense_bounds(form, scene, rays, "simple_box 1M"))
        compare_kernels(f"simple_box {ragged} rays", form, scene,
                        [c[:ragged] for c in rays], report, timed=False)
        compare_kernels("simple_box edges+vertices", form, scene, edges,
                        report)
        soup_ms = compare_kernels("soup 4095 tris", form, soup, soup_rays,
                                  report)
        times.update({f"soup_{k}": v for k, v in soup_ms.items()})
        soup_bounds = dense_bounds(form, soup, soup_rays, "soup 4095 tris")
        f = dense_form(form)
        for k, label, kind in zip(f["keys"], f["labels"],
                                  ("nearest hit", "any hit at 2 t")):
            log(f"  {label} soup 4095 x 65536 ({kind}): kernel "
                f"{soup_ms[k]:.4f} ms, plain {soup_ms[k + '_plain']:.4f} ms, "
                f"bound {soup_bounds[k][0]:.4f} ms ({soup_bounds[k][1]})")
    ragged_sets(dev, report)
    block_exit_set(dev)
    return report, times, bounds


RAGGED_RAYS = (1, 255, 257, 511, 513, 1001)
RAGGED_TRIS = (1, 12, 255, 256, 257, 300, 4095)


def ragged_sets(dev, report: dict):
    """The tiled kernels' ragged edges, both forms: ray counts below,
    around and off a 512-ray block, against soups of one triangle, of a
    256-triangle tile and around it, and of 16 tiles."""
    from tuturenderer_tpu_torch.tools.time_kernels import soup
    for n_tris in RAGGED_TRIS:
        scene = soup(n_tris, dev, seed=1)
        for n_rays in RAGGED_RAYS:
            gen = torch.Generator(device=dev).manual_seed(n_rays)
            o = torch.randn((n_rays, 3), generator=gen, device=dev) * 3.0
            rays = cols(o) + cols(random_unit(n_rays, gen, dev))
            for form in ("woop", "mt"):
                compare_kernels(f"ragged {n_rays} rays x {n_tris} tris",
                                form, scene, rays, report, timed=False,
                                quiet=True)
    log(f"  ragged: rays {RAGGED_RAYS} x triangles {RAGGED_TRIS}, both "
        "forms: every kernel equal to its plain version")


def block_exit_set(dev):
    """The any hits where whole blocks of rays settle at once: at the
    4095-triangle soup (16 tiles), rays 0-511 aimed at triangles 0-255
    with no distance limit (all blocked in the first tile), rays 512-1023
    at dist 0 (never blocked: every tile), a range that mixes them, rays
    1536-2047 blocked again, a ragged mixed end; each any hit timed
    there."""
    from tuturenderer_tpu_torch.tools.time_kernels import soup
    from tuturenderer_tpu_torch.utils.timing import device_ms
    scene = soup(4095, dev, seed=1)
    verts = torch.stack([torch.stack(list(v), 1)
                         for v in (scene.tv0, scene.tv1, scene.tv2)], 1)
    r = np.random.RandomState(9)
    n = 4 * 512 + 100
    aim = torch.from_numpy(r.randint(0, 256, n)).to(dev)
    o = torch.from_numpy((r.randn(n, 3) * 8.0).astype(np.float32)).to(dev)
    d = verts[aim].mean(dim=1) - o
    rays = cols(o) + cols(d / d.norm(dim=1, keepdim=True))
    dist = torch.full((n,), float("inf"), device=dev)
    dist[512:1024] = 0.0
    dist[1024 + 1:1536:2] = 0.0
    dist[2048 + 1::3] = 0.0
    for form in ("woop", "mt"):
        f = dense_form(form)
        table = f["pack"](scene)
        got = f["occ"](table, *rays, dist)
        want = f["occ_plain"](table, *rays, dist)
        n_diff = int((got != want).sum())
        blocks = [f"{want[lo:lo + 512].float().mean().item():.3f}"
                  for lo in range(0, n, 512)]
        ms = device_ms(lambda: f["occ"](table, *rays, dist))
        log(f"  block exits [{f['labels'][1]}]: blocked per 512 rays "
            f"{' '.join(blocks)}, disagree={n_diff}; {ms:.4f} ms")
        if n_diff:
            raise AssertionError(f"{f['labels'][1]} block exits: any hit "
                                 f"disagrees on {n_diff} rays")
        if not (bool(want[:512].all()) and not bool(want[512:1024].any())):
            raise AssertionError("the block-exit set lost its all-blocked "
                                 "and never-blocked blocks")


def bound(name: str, n_bytes: float, tests: float,
          flop_per_test: int = FLOP_PER_TEST, nodes: float = 0.0):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the fp32 operations of the tests (and BVH node visits) over
    the fp32 peak."""
    byte_ms = n_bytes / PEAK_BYTES * 1e3
    op_ms = (tests * flop_per_test + nodes * FLOP_PER_NODE) / PEAK_FP32 * 1e3
    by = "bytes" if byte_ms >= op_ms else "operations"
    log(f"  {name} bound: {n_bytes / 1e6:.2f} MB -> {byte_ms:.5f} ms, "
        f"{tests:.4g} tests x {flop_per_test} flop + {nodes:.4g} node "
        f"visits x {FLOP_PER_NODE} -> {op_ms:.5f} ms; bound by {by}")
    return max(byte_ms, op_ms), by


def dense_bounds(form: str, scene, rays, shape: str) -> dict:
    """A dense form's bounds at one ray set: rays read once (24 bytes, 28
    with dist), results written once (16, 4), the table once; tests:
    every triangle for the nearest hit, up to the first blocker for the
    any hit (at 2x the hit distance, the timed set)."""
    from tuturenderer_tpu_torch.tools.time_kernels import anyhit_tests
    f = dense_form(form)
    k_near, k_occ = f["keys"]
    table = f["pack"](scene)
    n, n_tris = rays[0].shape[0], table.shape[0] // f["floats"]
    t, idx, _, _ = f["near_plain"](table, *rays)
    dist = torch.where(idx >= 0, t, torch.full_like(t, 10.0)) * 2.0
    tbytes = table.numel() * 4
    k1, k2 = f["labels"]
    return {k_near: bound(f"{k1} {shape}", n * 40 + tbytes, n * n_tris,
                          f["flop"]),
            k_occ: bound(f"{k2} {shape}", n * 32 + tbytes,
                         anyhit_tests(f["tile"], f["floats"], table, rays,
                                      dist), f["flop"])}


def phase_slice(dev):
    log("== phase 4: render(simple_box(1024, 1024), RenderOptions(spp=64))")
    from tuturenderer_tpu_torch import materials
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.integrators.path import render, trace_rays
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.utils import rng
    from tuturenderer_tpu_torch.utils.profiling import measure_render
    opts = RenderOptions(spp=64)
    scene, cam = simple_box(1024, 1024, device=dev)
    # warm-up at a small size (allocator, lazy module loads); not counted
    s_small, c_small = simple_box(64, 64, device=dev)
    render(s_small, c_small, RenderOptions(spp=1), seed=0)
    torch.cuda.synchronize()

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rng.LAUNCHES = 0
    for k in materials.LAUNCHES:
        materials.LAUNCHES[k] = 0
    # timed by utils/profiling.py's measure_render (the card synchronised
    # at both edges); phase 23 prints its counters
    out = []
    stats = measure_render(lambda: out.append(render(scene, cam, opts,
                                                     seed=0)),
                           cam.width, cam.height, opts.spp, opts.max_depth)
    img, wall = out[0], stats.wall_s
    launches = dict(LAUNCHES)
    rng_launches = rng.LAUNCHES
    bsdf_launches = dict(materials.LAUNCHES)

    per_sample = {"nearest": opts.max_depth + 2, "anyhit": opts.max_depth + 1}
    check_launches(launches, {k: v * opts.spp for k, v in per_sample.items()})
    bounces = (opts.max_depth + 1) * opts.spp
    want = {"eval": 2 * bounces, "sample": bounces, "pdf": 2 * bounces}
    log(f"BSDF kernel launches: {bsdf_launches} (expected {want})")
    if bsdf_launches != want:
        raise AssertionError(f"BSDF launches {bsdf_launches}, expected "
                             f"{want}")
    launches.update({f"bsdf_{k}": n for k, n in bsdf_launches.items()})
    launches["rng_uniform"] = check_rng_launches(
        rng_launches, lambda: render(scene, cam, opts, seed=0), img, opts.spp)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render produced non-finite pixels")
    if tuple(img.shape) != (1024, 1024, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")

    fracs = report_render(scene, cam, opts, img, wall, dev)
    KEPT["simple_box"] = img.cpu().numpy()
    KEPT["simple_box stats"] = (stats, opts, fracs)
    return launches


def check_rng_launches(got: int, again, img, spp: int) -> int:
    """Hold the RNG kernel's launches in a render, ``got``, to the draws
    of the same render run again under ``utils/profiling.py``'s recorder
    (``again()``, bit-equal to ``img``): one launch an ``rng`` span, and
    every number drawn by the kernel. -> ``got``."""
    from tuturenderer_tpu_torch.utils import profiling, rng
    last = max((s.sid for s in profiling.recorded()), default=-1)
    before = rng.LAUNCHES
    with profiling.recording():
        img2 = again()
        torch.cuda.synchronize()
    # the buffer keeps spans in the order they close; a span's sid is the
    # order it opened in, so a render kept whole holds every sid after last
    new = [s for s in profiling.recorded() if s.sid > last]
    sids = sorted(s.sid for s in new)
    if not sids or sids != list(range(last + 1, sids[-1] + 1)):
        raise AssertionError("the span buffer dropped spans of the render")
    draws = [s for s in new if s.name == "rng"]
    numbers = sum(s.counts["draws"] for s in draws)
    kernel = sum(s.counts.get("kernel", 0) for s in draws)
    log(f"RNG kernel launches: {got} in the render ({got / spp:.2f} a "
        f"sample); its recorded run: {len(draws)} rng spans, "
        f"{rng.LAUNCHES - before} launches, {kernel} of {numbers} numbers "
        f"drawn by the kernel")
    if not torch.equal(img2, img):
        raise AssertionError("the recorded render differs from the render")
    if not got == len(draws) == rng.LAUNCHES - before or kernel != numbers:
        raise AssertionError(f"RNG kernel launches {got}, expected one an rng"
                             f" span ({len(draws)}); kernel drew {kernel} "
                             f"of {numbers}")
    return got


def rays_per_path(scene, cam, opts, dev):
    """(rays per path, live-lane fractions): the fractions entering each
    bounce come from one sample at every 4th pixel; 2 rays (intersection +
    shadow) per live lane and bounce, 1 for the epilogue's pending lanes
    (the accounting of bench.py:37-63)."""
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.integrators.path import trace_rays
    lane = torch.arange(0, cam.n_pixels, 4, dtype=torch.int32, device=dev)
    o, d, _ = primary_ray(cam, lane % cam.width, lane // cam.width)
    with torch.no_grad():
        _, counts = trace_rays(scene, cam, o, d, lane, 0, 0, opts,
                               collect_alive=True)
    fracs = counts.double().cpu().numpy() / lane.shape[0]
    return 2.0 * fracs[:-1].sum() + fracs[-1], fracs


def report_render(scene, cam, opts, img, wall: float, dev):
    """Log wall time, image mean and rays/s of a render; returns the live
    fractions."""
    rpp, fracs = rays_per_path(scene, cam, opts, dev)
    primary = cam.n_pixels * opts.spp
    mean = img.mean().item()
    log(f"render: wall={wall:.3f} s  image mean={mean:.6f}  "
        f"primary rays/s={primary / wall / 1e6:.2f} M  "
        f"total rays/s={primary * rpp / wall / 1e6:.2f} M  "
        f"(rays/path={rpp:.4f}, live fractions="
        f"{np.round(fracs, 4).tolist()})")
    return fracs


def check_launches(got: dict, want: dict):
    """Every kernel's launches in a run equal ``want`` (0 where absent)."""
    want = {k: want.get(k, 0) for k in got}
    log(f"launches: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")


def against_reference(name: str, scene, cam, opts, path: str):
    """Render at the reference's size, spp and seed on the card and hold
    the image to the stored JAX render at the CPU tests' bar."""
    from tuturenderer_tpu_torch.integrators.path import render
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               path))
    img = render(scene, cam, opts, seed=REF_SEED).cpu().numpy()
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    rel_mean = abs(img.mean() - ref.mean()) / ref.mean()
    log(f"{name}: pixels within rtol 1e-4 / atol 1e-5: "
        f"{close.mean() * 100:.2f}% (CPU test bar 99%), image mean "
        f"{img.mean():.6f} vs {ref.mean():.6f} (rel {rel_mean:.2e}, bar "
        f"0.5%); no widening")
    if close.mean() < 0.99 or rel_mean > 0.005:
        raise AssertionError(f"{name}: render disagrees with the JAX "
                             "reference")


def phase_reference(dev):
    log("== phase 5: against the stored JAX reference image")
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    scene, cam = simple_box(*REF_SIZE, device=dev)
    against_reference("simple_box", scene, cam, RenderOptions(spp=REF_SPP),
                      REF_IMAGE)


def translucent_showcase(width: int, height: int, nu: int = 224,
                         nv: int = 224, device="cuda"):
    """sphere_showcase with the sphere's material at alpha 0.5 (the same
    scene as tests/torch_port_util.py translucent_showcase)."""
    from tuturenderer_tpu_torch.camera import make_camera
    from tuturenderer_tpu_torch.models.meshes import plane, uv_sphere
    from tuturenderer_tpu_torch.scene.data import (LAMBERTIAN, MICROFACET_R,
                                                   SceneBuilder)
    b = SceneBuilder(bkgcolor=(0.05, 0.05, 0.08))
    sphere_mat = b.add_material(MICROFACET_R, diffuse=(0.8, 0.3, 0.2),
                                roughness=0.3, metallic=0.2, alpha=0.5)
    verts, normals = uv_sphere(radius=1.0, nu=nu, nv=nv)
    b.add_triangles(verts, normals, None, sphere_mat)
    ground = b.add_material(LAMBERTIAN, diffuse=(0.7, 0.7, 0.7))
    b.add_triangles(plane((0, -1, 0), (0, 0, 6), (6, 0, 0)), None, None,
                    ground)
    light = b.add_material(LAMBERTIAN, emission=(12.0, 11.0, 10.0))
    b.add_triangles(plane((0, 3, 0), (1, 0, 0), (0, 0, 1)), None, None,
                    light)
    scene = b.build(device=device)
    cam = make_camera(width, height, 45, eye=(0, 0.6, -3.5),
                      viewdir=(0, -0.12, 1), updir=(0, 1, 0), device=device)
    return scene, cam


def check_nearest(name: str, got, want):
    """A nearest-hit kernel's (t, idx, bu, bv) against the plain version's:
    t bit-equal, bu/bv equal wherever idx is (with t bit-equal, a differing
    idx is a triangle at the same t: a tie). Returns the number of idx
    differences."""
    tk, ik, uk, vk = got
    tp, ip, up, vp = want
    torch.cuda.synchronize()
    t_eq = bool((tk == tp).all())
    same = ik == ip
    uv_err = max((uk - up)[same].abs().max().item(),
                 (vk - vp)[same].abs().max().item()) if same.any() else 0.0
    idx_diff = int((~same).sum())
    log(f"  {name}: rays={tp.shape[0]} hit={(ip >= 0).float().mean():.4f} "
        f"t bit-equal={t_eq} idx differs (exact t ties)={idx_diff} "
        f"max|du|,|dv| where idx equal={uv_err:.3g}")
    if not t_eq or uv_err != 0.0:
        raise AssertionError(f"{name} disagrees with its plain version")
    return idx_diff


def compare_cluster_kernels(name: str, clusters, alpha_cl, rays,
                            shadows=None, dists=SHADOW_DISTS,
                            step: int = 1) -> dict:
    """K5, K6 and K7 (the BVH walk's three modes) against the plain
    versions on one ray set: t bit-equal, bu/bv equal wherever idx is,
    every any-hit mask equal, K7 within rtol 1e-5 / atol 1e-6. ``shadows``
    ({label: 6 columns + dist}) replaces the any-hit and K7 rays and
    distances when given ({} compares K5 alone); K7 runs on ``alpha_cl``.
    The kernels trace every ray, the plain versions every ``step``-th, and
    the two are compared there. Returns the max abs error per kernel."""
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    sub = lambda cs: [c[::step].contiguous() for c in cs]
    want = C.cluster_intersect_plain(clusters, *sub(rays))
    got = [g[::step] for g in C.cluster_intersect(clusters, *rays)]
    check_nearest(f"{name} K5", got, want)
    errs = {"cluster_nearest": 0.0, "cluster_anyhit": 0.0,
            "cluster_transmit": 0.0}
    if shadows is None:
        if step != 1:
            raise ValueError("distances from the hit need every ray")
        t_ref = torch.where(want[1] >= 0, want[0],
                            torch.full_like(want[0], 10.0))
        sets = [(f"t*{f}{off:+g}", rays, (t_ref * f + off).contiguous())
                for f, off in dists]
    else:
        sets = [(label, cols[:6], cols[6]) for label, cols in shadows.items()]
    for label, r6, dist in sets:
        sub_dist = dist[::step].contiguous()
        bp = C.cluster_occluded_plain(clusters, *sub(r6), sub_dist)
        bk = C.cluster_occluded(clusters, *r6, dist)[::step]
        n_diff = int((bk != bp).sum())
        xk = C.cluster_transmittance(alpha_cl, *r6, dist)[::step]
        xp = C.cluster_transmittance_plain(alpha_cl, *sub(r6), sub_dist)
        x_err = (xk - xp).abs().max().item()
        log(f"  {name}: dist={label} rays={dist.shape[0]} (plain on every "
            f"{step}) K6 blocked={bp.float().mean():.4f} "
            f"disagree={n_diff}; K7 mean={xp.mean():.4f} at 0 "
            f"{(xp == 0).float().mean():.4f} max|err|={x_err:.3g}")
        if n_diff:
            raise AssertionError(f"{name}: any hit disagrees on {n_diff} "
                                 "rays")
        torch.testing.assert_close(xk, xp, rtol=1e-5, atol=1e-6)
        errs["cluster_transmit"] = max(errs["cluster_transmit"], x_err)
    return errs


def log_tables(title: str, scene, build_s: float):
    """Log a cluster scene's table sizes and the seconds its BVH takes to
    build on the host (rebuilt here from the tables, timed alone)."""
    from tuturenderer_tpu_torch.ops.cluster import (BVH_LEAF, build_bvh,
                                                    build_tree)
    cl = scene.clusters
    host = lambda a: a.cpu().numpy()
    aabb, woop, tri_idx = host(cl.aabb), host(cl.woop), host(cl.tri_idx)
    t0 = time.perf_counter()
    link = build_tree(aabb)
    t1 = time.perf_counter()
    _, _, _, depth = build_bvh(aabb, woop, tri_idx, link)
    t2 = time.perf_counter()
    log(f"{title}: {scene.n_tris} triangles, "
        f"{int((cl.tri_idx[:, 0] >= 0).sum())} clusters, scene built in "
        f"{build_s:.2f} s; cluster tree {len(link)} nodes built in "
        f"{t1 - t0:.2f} s; BVH {cl.bvh_nodes.shape[0]} nodes of depth "
        f"{depth}, leaves of at most {BVH_LEAF} rows, built in "
        f"{t2 - t1:.2f} s")


def walk_calls(cl, alpha_cl, near, occ) -> dict:
    """key -> (TPU kernel label, wrapper, tables, rays) of K5, K6 and K7 on
    one wavefront; K7 on ``alpha_cl``, with K6's shadow rays."""
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    return {"cluster_nearest": ("K5", C.cluster_intersect, cl, near),
            "cluster_anyhit": ("K6", C.cluster_occluded, cl, occ),
            "cluster_transmit": ("K7", C.cluster_transmittance, alpha_cl,
                                 occ)}


def walk_stats(name: str, cl, alpha_cl, near, occ) -> dict:
    """K5, K6 and K7 on one wavefront: device ms of each, read twice in
    turns (K5 K6 K7 K7 K6 K5), ray/triangle tests and node visits per ray,
    and the bound of each: the rays read once (24 bytes, 28 with dist), the
    results written once (16 bytes K5, 4 K6/K7), and the tables each reads
    (nodes and rows; virt and tri_idx for K5; virt and one alpha per real
    row for K7)."""
    from tuturenderer_tpu_torch.utils.timing import device_ms
    calls = walk_calls(cl, alpha_cl, near, occ)
    n = near[0].shape[0]
    size = lambda ts: sum(a.numel() * a.element_size() for a in ts)
    tree = size((cl.bvh_nodes, cl.bvh_rows))
    table_bytes = {"cluster_nearest": tree + size((cl.bvh_virt, cl.tri_idx)),
                   "cluster_anyhit": tree,
                   "cluster_transmit": tree + size((cl.bvh_virt,)) +
                   4 * cl.n_real}
    ray_bytes = {"cluster_nearest": 40, "cluster_anyhit": 32,
                 "cluster_transmit": 32}
    order = list(calls) + list(calls)[::-1]
    turns = {k: [] for k in calls}
    for k in order:
        _, fn, table, args = calls[k]
        turns[k].append(device_ms(lambda: fn(table, *args)))
    out = {}
    for k, (label, fn, table, args) in calls.items():
        tests = torch.zeros(1, dtype=torch.int64, device=near[0].device)
        nodes = torch.zeros_like(tests)
        fn(table, *args, test_count=tests, node_count=nodes)
        tests, nodes = float(tests.item()), float(nodes.item())
        ms = sum(turns[k]) / 2
        log(f"  {label} {name}: {n} rays: device ms {turns[k][0]:.4f} "
            f"{turns[k][1]:.4f} (mean {ms:.4f}); tests/ray {tests / n:.2f}, "
            f"node visits/ray {nodes / n:.2f}")
        b_ms, b_by = bound(f"{label} {name}",
                           n * ray_bytes[k] + table_bytes[k], tests,
                           nodes=nodes)
        out[k] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                  "tests_per_ray": tests / n, "nodes_per_ray": nodes / n}
    slices(name, calls)
    return out


def slices(name: str, calls: dict, size: int = 8192):
    """Each walk kernel's device ms on each ``size``-ray slice of a
    wavefront alone (64 blocks of 128 rays: less than one wave on the card,
    so a slice takes about as long as its slowest warp) against the whole
    launch: the long warps' tail, apart from throughput."""
    from tuturenderer_tpu_torch.utils.timing import device_ms
    for label, fn, table, args in calls.values():
        ms = [device_ms(lambda p=[c[lo:lo + size].contiguous() for c in args]:
                        fn(table, *p), reps=5, warm=1, hold_ms=5.0)
              for lo in range(0, args[0].shape[0], size)]
        whole = device_ms(lambda: fn(table, *args))
        log(f"  {label} {name}: whole launch {whole:.4f} ms; each {size}-ray "
            f"slice alone, in ray order: {' '.join(f'{m:.4f}' for m in ms)}"
            f" (max {max(ms):.4f} = {max(ms) / whole:.2f} of the whole)")


def compare_timers(calls: dict):
    """Each walk kernel at the showcase wavefront between CUDA events
    (``utils/timing.py``) and under the profiler's CUDA trace, in turns
    (events, profiler, profiler, events), with the kernel records the trace
    kept. The any-hit wrapper's ``hit != 0`` is in the event time only."""
    from tuturenderer_tpu_torch.utils.timing import device_ms
    for label, fn, table, args in calls.values():
        call = lambda: fn(table, *args)
        ev = [device_ms(call)]
        prof = [profiler_ms(call, "bvh_walk_kernel") for _ in range(2)]
        ev.append(device_ms(call))
        log(f"  timers, {label} at the showcase wavefront: events "
            f"{ev[0]:.4f} {ev[1]:.4f} ms; profiler " +
            " ".join(f"{ms:.4f} ms ({kept} of {want} records)"
                     for ms, kept, want in prof))


def phase_cluster_kernels(dev):
    log("== phase 6: cluster kernels vs plain on the card")
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase, terrain
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    from tuturenderer_tpu_torch.tools.time_kernels import (alpha_table,
                                                           wavefront)
    from tuturenderer_tpu_torch.utils.timing import device_ms
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}

    def ray_set(scene, cam, n):
        """n/2 camera rays at random pixels, n/2 random bounce rays from
        random points in the scene's box."""
        cl = scene.clusters
        pix = torch.randperm(cam.n_pixels, generator=gen, device=dev)[:n // 2]
        o, d, _ = primary_ray(cam, pix % cam.width, pix // cam.width)
        ob = cl.scene_lo + (cl.scene_hi - cl.scene_lo) * torch.rand(
            (n - n // 2, 3), generator=gen, device=dev)
        o = torch.cat([torch.stack(list(o), 1), ob])
        d = torch.cat([torch.stack(list(d), 1),
                       random_unit(n - n // 2, gen, dev)])
        return cols(o) + cols(d)

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    t0 = time.perf_counter()
    scene, cam = sphere_showcase(512, 512, device=dev)
    log_tables("sphere_showcase(512, 512)", scene, time.perf_counter() - t0)
    cl = scene.clusters
    alpha_cl = alpha_table(cl, dev)
    merge(compare_cluster_kernels("sphere_showcase", cl, alpha_cl,
                                  ray_set(scene, cam, 65536)))

    near, occ = wavefront(scene, cam)
    merge(compare_cluster_kernels("sphere_showcase wavefront", cl, alpha_cl,
                                  near, shadows={"wavefront dist": occ}))

    # device time, tests and node visits per ray and bound at the main
    # path's shapes, then the plain versions
    n = near[0].shape[0]
    stats = walk_stats("showcase wavefront", cl, alpha_cl, near, occ)
    plain = {"cluster_nearest": (C.cluster_intersect_plain, cl, near),
             "cluster_anyhit": (C.cluster_occluded_plain, cl, occ),
             "cluster_transmit": (C.cluster_transmittance_plain, alpha_cl,
                                  occ)}
    for k, (fn, table, args) in plain.items():
        stats[k]["plain_ms"] = device_ms(lambda: fn(table, *args), reps=2,
                                         warm=1, hold_ms=0)
        log(f"  {k}: {n} rays of the showcase wavefront: device ms kernel="
            f"{stats[k]['ms']:.4f} plain={stats[k]['plain_ms']:.4f}")
    compare_timers(walk_calls(cl, alpha_cl, near, occ))
    del scene, cam, cl, alpha_cl, near, occ

    t0 = time.perf_counter()
    scene, cam = terrain(512, 512, nx=724, nz=724, device=dev)
    log_tables("terrain(512, 512, nx=724, nz=724)", scene,
               time.perf_counter() - t0)
    cl = scene.clusters
    alpha_cl = alpha_table(cl, dev)
    merge(compare_cluster_kernels("terrain", cl, alpha_cl,
                                  ray_set(scene, cam, 16384)))
    near, occ = wavefront(scene, cam)
    merge(compare_cluster_kernels("terrain wavefront", cl, alpha_cl, near,
                                  shadows={"wavefront dist": occ},
                                  step=4))
    walk_stats("terrain wavefront", cl, alpha_cl, near, occ)
    return errs, stats


def timed(fn):
    """(fn's result, wall s, kernel launches) of one call, the launch counts
    zeroed just before it."""
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(LAUNCHES)


# the cluster plain versions of phases 14-20 trace at most this many of a
# captured call's rays (every n // PLAIN_RAYS-th); the kernels, and the
# dense plain versions, trace all of them
PLAIN_RAYS = 1 << 16


def compare_captured(name: str, got: dict, alpha_cl=None) -> dict:
    """The kernels against their plain versions on a render's captured
    inputs (``tools/time_kernels.py`` ``capture``): the nearest-hit call
    and every shadow call of
    ``got``, dense (K1/K2) or cluster (K5-K7; K7 on ``alpha_cl``, by
    default the scene's table with alphas drawn by ``alpha_table``), the
    cluster plain versions on at most PLAIN_RAYS rays of each, the dense
    ones on every ray. Returns the max abs error per kernel."""
    from tuturenderer_tpu_torch.tools.time_kernels import alpha_table
    near = {k: v for k, v in got.items() if k.endswith("intersect")}
    (near_name, calls), = near.items()
    (label, (table, rays)), = calls.items()
    shadows = {lab: cols for k, v in got.items() if k not in near
               for lab, (_, cols) in v.items()}
    log(f"  {name}: the kernels against their plain versions on the "
        f"render's own inputs: nearest hit at {label} "
        f"({rays[0].shape[0]} rays), shadow calls "
        f"{[f'{lab} ({c[0].shape[0]} rays)' for lab, c in shadows.items()]}")
    if near_name == "tri_intersect":
        errs = {}
        compare_kernels(f"{name}, {label}", "woop", None, rays, errs,
                        timed=False, shadows=shadows, table=table)
        return errs
    step = max(1, max(c[0].shape[0] for c in [rays, *shadows.values()])
               // PLAIN_RAYS)
    if alpha_cl is None:
        alpha_cl = alpha_table(table, table.woop.device)
    return compare_cluster_kernels(f"{name}, {label}", table, alpha_cl,
                                   rays, shadows=shadows, step=step)


def merge_errs(into: dict, errs: dict):
    for k, v in errs.items():
        into[k] = max(into.get(k, 0.0), v)


def timed_render(scene, cam, opts, dev):
    """(image, wall s, launches) of one render, counts zeroed just before."""
    from tuturenderer_tpu_torch.integrators.path import render
    img, wall, launches = timed(lambda: render(scene, cam, opts, seed=0))
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render produced non-finite pixels")
    if tuple(img.shape) != (cam.height, cam.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    return img, wall, launches


def phase_mesh_slice(dev) -> dict:
    """The three mesh-scale renders; returns each one's launches."""
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase, terrain
    from tuturenderer_tpu_torch.options import RenderOptions
    runs = {}
    # warm-up at a small size (allocator, lazy module loads); not counted
    s_small, c_small = sphere_showcase(64, 64, nu=46, nv=46, device=dev)
    render(s_small, c_small, RenderOptions(spp=1, alpha_shadows=True))

    cases = (
        ("sphere_showcase", "render(sphere_showcase(512, 512), "
         "RenderOptions(spp=16))",
         lambda: sphere_showcase(512, 512, device=dev), RenderOptions(spp=16),
         "cluster_anyhit"),
        ("terrain", "render(terrain(512, 512, nx=724, nz=724), "
         "RenderOptions(spp=4))",
         lambda: terrain(512, 512, nx=724, nz=724, device=dev),
         RenderOptions(spp=4), "cluster_anyhit"),
        ("translucent", "render(translucent showcase(256, 256), "
         "RenderOptions(spp=4, alpha_shadows=True))",
         lambda: translucent_showcase(256, 256, device=dev),
         RenderOptions(spp=4, alpha_shadows=True), "cluster_transmit"))
    for i, (key, title, make, opts, shadow) in enumerate(cases):
        log(f"== phase 7.{i + 1}: {title}")
        t0 = time.perf_counter()
        scene, cam = make()
        log(f"{scene.n_tris} triangles, scene built in "
            f"{time.perf_counter() - t0:.2f} s")
        img, wall, launches = timed_render(scene, cam, opts, dev)
        check_launches(launches, {
            "cluster_nearest": (opts.max_depth + 2) * opts.spp,
            shadow: (opts.max_depth + 1) * opts.spp})
        report_render(scene, cam, opts, img, wall, dev)
        runs[key] = launches
        if key != "terrain":
            KEPT[key] = img.cpu().numpy()
        del scene, cam, img
    return runs


def phase_mesh_references(dev):
    log("== phase 8: mesh-scale renders against the stored JAX references")
    for name in MESH_NAMES:
        against_integrator_reference(name, dev)


@contextlib.contextmanager
def dense_kernel(form: str):
    """The port's dense route in ``form`` within the block."""
    from tuturenderer_tpu_torch.ops import intersect as TI
    saved = TI.DENSE_KERNEL
    TI.DENSE_KERNEL = form
    try:
        yield
    finally:
        TI.DENSE_KERNEL = saved


def fwd_bwd(scene, cam, opts, seed: int = 1, renderer: str = "render_diff"):
    """Forward and backward of mean(``renderer`` of grad.py) with every
    launch count zeroed just before -> (image, gradient leaves, wall s,
    launches, peak device bytes during the call, bytes allocated before
    it)."""
    from tuturenderer_tpu_torch import grad
    from tuturenderer_tpu_torch.grad import MaterialParams, get_params
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    render_diff = getattr(grad, renderer)
    leaves = [a.detach().clone().requires_grad_(True)
              for a in get_params(scene).leaves()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img = render_diff(MaterialParams.from_leaves(leaves), scene, cam, opts,
                      seed)
    grads = torch.autograd.grad(img.mean(), leaves, allow_unused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{renderer} produced non-finite pixels")
    bad = [GRAD_LEAVES[i] for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all())]
    if bad:
        raise AssertionError(f"non-finite gradient leaves: {bad}")
    return img.detach(), grads, wall, launches, peak, before


def fd_check(name: str, scene, cam, opts, seed: int, leaf: int, idx: int,
             ad: float, eps: float = 1e-2, renderer: str = "render_diff"):
    """Central finite difference of the image mean of ``renderer`` (of
    grad.py) in one parameter, at the gradient's seed; relative error
    < 0.05 (bench.py:183-195)."""
    from tuturenderer_tpu_torch import grad
    from tuturenderer_tpu_torch.grad import MaterialParams, get_params
    render_diff = getattr(grad, renderer)
    flat = get_params(scene).leaves()

    def loss(sign: float) -> float:
        fl = [a.clone() for a in flat]
        fl[leaf][idx] += sign * eps
        with torch.no_grad():
            return render_diff(MaterialParams.from_leaves(fl), scene, cam,
                               opts, seed).double().mean().item()

    fd = (loss(1.0) - loss(-1.0)) / (2 * eps)
    rel = abs(fd - ad) / max(abs(fd), 1e-12)
    log(f"{name}: d mean / d {GRAD_LEAVES[leaf]}[{idx}]: autograd {ad:.6g}, "
        f"central difference (eps {eps}) {fd:.6g}, relative error "
        f"{rel:.4f} (bar 0.05)")
    if not ad or rel >= 0.05:
        raise AssertionError(f"{name}: gradient and finite difference "
                             "disagree")


def report_fwd_bwd(name: str, scene, cam, opts, wall: float, peaks: dict,
                   dev):
    rpp, _ = rays_per_path(scene, cam, opts, dev)
    rays = cam.n_pixels * opts.spp * rpp
    log(f"{name}: forward+backward wall={wall:.3f} s  "
        f"{rays / wall / 1e6:.2f} M rays/s ({rpp:.4f} rays/path, "
        f"bench.py's accounting); peak device memory above the scene: "
        + ", ".join(f"{spp} spp {gb:.3f} GB" for spp, gb in peaks.items()))


def device_share(fn):
    """(wall s, device s, the five kernels with the most device time as
    (name, s, launches)) of one call under the profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return wall, busy, [(e.key[:60], e.self_device_time_total / 1e6, e.count)
                        for e in events[:5]]


def gather_backward_ms(dev, n: int = 1 << 20, m: int = 6, reps: int = 5):
    """ms per call, between CUDA events around ``reps`` back-to-back calls,
    of a per-lane gather from an [m] table at n lanes and its backward:
    ``table[i]`` (the backward sorts the indices) and ``index_select``
    (the backward adds into the rows), the two ways plain indexing can
    take."""
    table = torch.rand(m, device=dev, requires_grad=True)
    idx = torch.randint(0, m, (n,), device=dev)
    g = torch.rand(n, device=dev)

    def by(gather) -> float:
        call = lambda: torch.autograd.grad(gather(), table, g)
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    return by(lambda: table[idx]), \
        by(lambda: torch.index_select(table, 0, idx))


def phase_train_dense(dev) -> dict:
    log("== phase 9: forward+backward of mean(render_diff(simple_box(1024, "
        "1024))) at 8 spp, Moller-Trumbore form (K3/K4)")
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    with dense_kernel("mt"):
        # warm-up at a small size (allocator, lazy module loads); not counted
        fwd_bwd(*simple_box(64, 64, device=dev), RenderOptions(spp=1))
        scene, cam = simple_box(1024, 1024, device=dev)
        peaks, runs = {}, {}
        for spp in (2, 8):
            opts = RenderOptions(spp=spp)
            img, grads, wall, launches, peak, before = fwd_bwd(scene, cam,
                                                               opts)
            depth = opts.max_depth + 1
            check_launches(launches, {"mt_nearest": (3 * depth + 2) * spp,
                                      "mt_anyhit": 3 * depth * spp})
            peaks[spp] = (peak - before) / 1e9
            runs[spp] = (img, grads, wall, launches)
        img, grads, wall, launches = runs[8]
        log(f"image mean={img.mean().item():.6f}; red wall diffuse gradient "
            f"{[round(float(g[1]), 6) for g in grads[:3]]}")
        report_fwd_bwd("simple_box 1024^2 x 8 spp", scene, cam, opts, wall,
                       peaks, dev)
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.3f}"
            " GB allocated in all at 8 spp")
        if peaks[8] > 1.5 * peaks[2]:
            raise AssertionError("peak memory grows with spp")
        # the red wall is material 1; diffuse.x is leaf 0
        fd_check("simple_box", scene, cam, opts, 1, 0, 1, float(grads[0][1]))
        wall1, busy, top = device_share(
            lambda: fwd_bwd(scene, cam, RenderOptions(spp=1)))
        log(f"one sample forward+backward under the profiler: wall "
            f"{wall1:.3f} s, device busy {busy:.3f} s "
            f"({busy / wall1 * 100:.1f} %); most device time: " +
            "; ".join(f"{k} {t:.3f} s x{c}" for k, t, c in top))
    ms_index, ms_select = gather_backward_ms(dev)
    log(f"a gather from 6 rows at 1,048,576 lanes and its backward, per "
        f"call between CUDA events: table[i] {ms_index:.3f} ms, "
        f"index_select {ms_select:.3f} ms")
    return launches


def phase_train_mesh(dev) -> dict:
    log("== phase 10: forward+backward of mean(render_diff(sphere_showcase("
        "256, 256))) at 8 spp (K5/K6)")
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    scene, cam = sphere_showcase(256, 256, device=dev)
    opts = RenderOptions(spp=8)
    img, grads, wall, launches, peak, before = fwd_bwd(scene, cam, opts)
    depth = opts.max_depth + 1
    check_launches(launches, {"cluster_nearest": (3 * depth + 2) * opts.spp,
                              "cluster_anyhit": 3 * depth * opts.spp})
    log(f"image mean={img.mean().item():.6f}")
    report_fwd_bwd("sphere_showcase 256^2 x 8 spp", scene, cam, opts, wall,
                   {8: (peak - before) / 1e9}, dev)
    # the sphere is material 0
    fd_check("sphere_showcase", scene, cam, opts, 1, 0, 0, float(grads[0][0]))
    return launches


def phase_training_steps(dev):
    log("== phase 11: inverse rendering, 10 steps on simple_box(256, 256), "
        "Moller-Trumbore form")
    from tuturenderer_tpu_torch.grad import get_params, invert_materials
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.utils.vec import Vec3
    with dense_kernel("mt"):
        scene, cam = simple_box(256, 256, device=dev)
        opts = RenderOptions(spp=4, samples_per_launch=4)
        target = render(scene, cam, opts, seed=1000)
        truth = get_params(scene)
        # the red wall (material 1) starts at test_cli.py's wrong albedo
        diffuse = [a.clone() for a in truth.diffuse]
        for c, v in zip(diffuse, (0.2, 0.6, 0.7)):
            c[1] = v
        start = truth._replace(diffuse=Vec3(*diffuse))
        t0 = time.perf_counter()
        params, losses = invert_materials(start, target, scene, cam, opts,
                                          steps=10, lr=5.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    red = lambda p: torch.stack([c[1] for c in p.diffuse]).cpu()
    for step, loss in enumerate(losses):
        log(f"  step {step}: loss {loss:.6f}")
    log(f"red wall diffuse: start {red(start).tolist()} -> recovered "
        f"{[round(v, 4) for v in red(params).tolist()]}, truth "
        f"{[round(v, 4) for v in red(truth).tolist()]}; {wall:.2f} s for "
        f"{len(losses)} steps")
    gap = lambda p: float((red(p) - red(truth)).abs().sum())
    # each step renders new samples, so the loss carries Monte Carlo noise:
    # the last three steps' mean must be below the first step's loss
    if not np.mean(losses[-3:]) < losses[0] or not gap(params) < gap(start):
        raise AssertionError("the training steps did not lower the loss "
                             "and move the albedo toward the truth")


def stored_reference(name: str):
    """(arrays, case) of ``tests/data/torch_<name>_jax_ref.npz``."""
    ref = dict(np.load(root_path(
        "tests", "data", f"torch_{name.replace('-', '_')}_jax_ref.npz")))
    return ref, json.loads(str(ref.pop("case")))


def against_grad_reference(name: str, dev):
    """The card's image and gradients of one stored JAX gradient case
    (``tests/data/torch_grad_<name>_jax_ref.npz``: the scene and camera
    tables and ``case``, the renderer, options and seed), in the
    Moller-Trumbore dense form as the JAX package's CPU route computes: the
    image at the render bar, each leaf within 1e-2 of its largest
    magnitude."""
    from tuturenderer_tpu_torch.camera import camera_from_numpy
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.data import scene_from_numpy
    ref, case = stored_reference(f"grad-{name}")
    sub = lambda pre: {k[len(pre):]: v for k, v in ref.items()
                       if k.startswith(pre)}
    scene = scene_from_numpy(sub("scene."), device=dev)
    cam = camera_from_numpy(sub("camera."), device=dev)
    with dense_kernel("mt"):
        img, grads, _, _, _, _ = fwd_bwd(scene, cam,
                                         RenderOptions(**case["options"]),
                                         seed=case["seed"],
                                         renderer=case["renderer"])
    img = img.cpu().numpy()
    close = np.isclose(img, ref["image"], rtol=1e-4, atol=1e-5).all(axis=-1)
    rel_mean = abs(img.mean() - ref["image"].mean()) / ref["image"].mean()
    worst = 0.0
    for key, g in zip(GRAD_LEAVES, grads):
        want = ref[f"grad.{key}"]
        scale = max(np.abs(want).max(), 1e-12)
        worst = max(worst, np.abs(g.cpu().numpy() - want).max() / scale)
    log(f"{name} ({case['renderer']}, {case['scene']}, {case['options']}): "
        f"pixels within rtol 1e-4 / atol 1e-5: {close.mean() * 100:.2f}% "
        f"(bar 99%), image mean rel {rel_mean:.2e} (bar 0.5%), worst "
        f"gradient leaf error {worst:.3g} of its largest magnitude (bar "
        f"1e-2)")
    if close.mean() < 0.99 or rel_mean > 0.005 or worst > 1e-2:
        raise AssertionError(f"{name}: the card's gradients disagree with "
                             "the JAX reference")


def phase_grad_references(dev):
    log("== phase 12: the card's gradients against the stored JAX "
        "gradients")
    for name in GRAD_NAMES:
        against_grad_reference(name, dev)


def phase_visit(dev, nc: int = 1024, n_tiles: int = 64, reps: int = 10):
    """K8 at the prototype's size: nc clusters, n_tiles tiles of 1024 rays
    (tools/proto_visit.py main)."""
    log("== phase 13: the visit-walk probe (K8)")
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    from tuturenderer_tpu_torch.tools import proto_visit as P
    from tuturenderer_tpu_torch.tools import time_kernels as TK
    from tuturenderer_tpu_torch.utils.timing import device_ms
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    P.main(nc=nc, n_tiles=n_tiles, reps=reps, device=dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check_launches(launches, {"proto_visit": 2 * (1 + reps)})

    err = 0.0
    cases = [(name, n_tiles, dead) for name in ("early", "full", "special")
             for dead in (False, True)] + \
        [(name, 3, True) for name in ("early", "full", "special")]
    for name, tiles, dead in cases:
        a = P.scenario(name, nc, tiles)
        if dead:
            a["live"][:P.TILE:3] = 0.0                  # a third of tile 0
            a["live"][P.TILE:2 * P.TILE:2] = 0.0        # tile 1 half dead
            a["live"][(tiles - 1) * P.TILE:] = 0.0      # the last wholly
        args = P.tensors(a, dev)
        t, idx = P.run(*args, nc=nc)
        tp, ip, groups = P.walk_plain(*args, nc=nc)
        torch.cuda.synchronize()
        t_eq = bool((t == tp).all())
        n_idx = int((idx != ip).sum())
        log(f"  {name} x {tiles} tiles{' with dead lanes' if dead else ''}: "
            f"t bit-equal={t_eq} idx differs={n_idx}; groups walked per "
            f"tile {sorted(set(groups.tolist()))}")
        if not t_eq or n_idx:
            raise AssertionError(f"K8 {name}: kernel and plain differ")
        err = max(err, (t - tp).abs().max().item())
        if name != "special":
            P.check(name, t[:P.TILE], idx[:P.TILE])

    # time, plane tests, issue slots and bound at the full walk, the
    # probe's heavy case, and the early exit's time
    a = P.scenario("full", nc, n_tiles)
    args = P.tensors(a, dev)
    launch = lambda a=args: P._launch(a[0], a[1], a[2:9], a[9], nc, n_tiles)
    # run checks its visit lists on the host, so each call synchronises:
    # the kernel's time is its launch's alone, held; run's own time (hold 0)
    # and the profiler's reading of run's kernels are logged beside it
    ms = device_ms(launch, reps=10, warm=2)
    early = P.tensors(P.scenario("early", nc, n_tiles), dev)
    early_ms = device_ms(lambda: P._launch(early[0], early[1], early[2:9],
                                           early[9], nc, n_tiles))
    run_ms = device_ms(lambda: P.run(*args, nc=nc), reps=10, warm=2,
                       hold_ms=0)
    prof_ms, kept, want = profiler_ms(lambda: P.run(*args, nc=nc),
                                      "visit_walk", reps=10, warm=2)
    plain_ms = device_ms(lambda: P.run_plain(*args, nc=nc), reps=2, warm=1,
                         hold_ms=0)
    _, _, groups = P.walk_plain(*args, nc=nc)
    tests = TK.visit_tests(args[1], groups, nc)
    n = n_tiles * P.TILE
    walked = torch.cat([args[0].reshape(n_tiles, nc)[i, :int(g) * P.G]
                        for i, g in enumerate(groups.tolist())])
    n_bytes = n * (7 * 4 + 8) + n_tiles * nc * 8 + \
        torch.unique(walked).numel() * P.CS * 4 * 4
    ids = P.sm_ids(args[0], args[1], args[2:9], args[9], nc, n_tiles)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = TK.sm_clock_mhz(launch, burst=max(5, int(300 / ms)))
    slots = ms * 1e-3 * n_sms * 4 * mhz * 1e6 / (tests / 32)
    log(f"  full walk: {n} rays x {nc} clusters: device ms kernel={ms:.4f} "
        f"plain={plain_ms:.4f}; run with its check {run_ms:.4f} (events, "
        f"unheld), its kernel under the profiler {prof_ms:.4f} ({kept} of "
        f"{want} records); plane tests/ray={tests / n:.0f}; early exit "
        f"{early_ms:.4f} ms")
    log(f"  full walk: {ids.numel()} CTAs on {torch.unique(ids).numel()} of "
        f"{n_sms} SMs; SM clock under load {mhz:.0f} MHz; "
        f"{slots:.1f} warp-instruction slots per plane test")
    b_ms, b_by = bound("K8 full walk", n_bytes, tests, FLOP_PER_PLANE)
    return launches, err, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by}


# ------------------------------------------------------------------ phase 14

# tests/test_golden.py's oracle quirk profile and truncating quantization;
# the two configs the path tracer serves, each at two seeds
GOLDEN_CASES = (("mft_128.txt", "mft_128_ref.ppm"),
                ("tex_128.txt", "tex_128_ref.ppm"))
GOLDEN_SEEDS = (9, 23)
GOLDEN_SPP = 64
ORACLE = dict(tutu_light_pick=True, tutu_tri_sample=True,
              ggx_sample_bug=True)


def quantize(img):
    """The reference's pixel write: gamma 0.78 then TRUNCATING 8-bit
    quantization ((int)(255*v), PPMGenerator.hpp:825-843)."""
    return np.floor(np.clip(np.asarray(img), 0.0, 1.0) ** 0.78 * 255.0) / 255.0


def block_mean(img, b):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def compare(golden, ours, blk, t_block, t_meanabs, t_mean):
    g8 = block_mean(golden, blk)
    o8 = block_mean(ours, blk)
    assert np.abs(g8 - o8).max() < t_block, \
        f"max block diff {np.abs(g8 - o8).max():.4f}"
    assert np.abs(golden - ours).mean() < t_meanabs, \
        f"mean abs diff {np.abs(golden - ours).mean():.4f}"
    assert abs(golden.mean() - ours.mean()) < t_mean, \
        f"mean diff {abs(golden.mean() - ours.mean()):.4f}"


def root_path(*parts) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *parts)


def golden_config(name: str, directory: str) -> str:
    """A copy of ``golden/<name>`` in ``directory`` whose texture paths
    (absolute, valid only where the repository was when the file was
    written) point at the files of those names in this checkout's
    golden/tex/."""
    from tuturenderer_tpu_torch.scene.config import relocate_config
    return relocate_config(root_path("golden", name),
                           os.path.join(directory, name),
                           root_path("golden", "tex"))


def path_launches(opts, nearest: str, shadow: str) -> dict:
    """A path-tracer render's launches: per wavefront (max_depth + 2)
    nearest hits and (max_depth + 1) shadow calls, spp /
    samples_per_launch wavefronts; a shrink launches nothing."""
    batches = opts.spp // max(1, opts.samples_per_launch)
    return {nearest: (opts.max_depth + 2) * batches,
            shadow: (opts.max_depth + 1) * batches}


def phase_golden(dev) -> dict:
    """render_config of the two oracle configs at both seeds, held to the
    reference renderer's images, and K1/K2 against their plain versions on
    each config's render; the mesh-scale oracle config parsed and built; a
    P3 round trip. Returns the kernels' max abs errors."""
    log("== phase 14: the config entry point: render_config of golden/"
        "mft_128.txt and tex_128.txt at 128x128 x 64 spp (one wavefront, "
        "samples_per_launch=64, oracle quirk profile) against the reference "
        "renderer's images")
    import tempfile

    from tuturenderer_tpu_torch.io.ppm import read_ppm, write_ppm
    from tuturenderer_tpu_torch.io.ppm import quantize as write_quantize
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.render import render_config
    from tuturenderer_tpu_torch.scene.config import parse_config
    from tuturenderer_tpu_torch.tools.time_kernels import at, capture
    opts = RenderOptions(spp=GOLDEN_SPP, samples_per_launch=GOLDEN_SPP,
                         **ORACLE)
    want = path_launches(opts, "nearest", "anyhit")
    tmp = tempfile.mkdtemp()
    out_dir = root_path("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    errs = {}
    for config, ppm in GOLDEN_CASES:
        path = golden_config(config, tmp)
        golden = read_ppm(root_path("golden", ppm))
        for seed in GOLDEN_SEEDS:
            img, wall, launches = timed(lambda: render_config(
                path, opts, seed=seed, verbose=False, device=dev))
            log(f"{config} seed {seed}: wall={wall:.3f} s; launches "
                f"(max_depth + 2) x spp/samples_per_launch nearest, "
                f"(max_depth + 1) x spp/samples_per_launch any hit:")
            check_launches(launches, want)
            if img.shape != golden.shape or not np.isfinite(img).all():
                raise AssertionError(f"{config}: image {img.shape}")
            ours = quantize(img)
            blk = np.abs(block_mean(golden, 16) - block_mean(ours, 16)).max()
            log(f"  against golden/{ppm}: max 16x16 block diff {blk:.5f} "
                f"(bar 0.025), mean abs diff "
                f"{np.abs(golden - ours).mean():.5f} (bar 0.03), mean diff "
                f"{abs(golden.mean() - ours.mean()):.5f} (bar 0.006); "
                f"image mean {img.mean():.6f}")
            compare(golden, ours, 16, 0.025, 0.03, 0.006)
        # the inputs this render gives K1 and K2 (one more render, not
        # timed): the first bounce's nearest hits and its NEE shadow rays
        with capture(tri_intersect={"bounce 1": at(1)},
                     tri_occluded={"NEE at bounce 1": at(1)}) as got:
            render_config(path, opts, seed=GOLDEN_SEEDS[0], verbose=False,
                          device=dev)
        merge_errs(errs, compare_captured(
            f"{config} seed {GOLDEN_SEEDS[0]}", got))
        # the reference's P3 write and read, round trip
        ppm_path = os.path.join(out_dir, config.replace(".txt", ".ppm"))
        write_ppm(ppm_path, img)
        back = read_ppm(ppm_path)
        if not np.array_equal(back, write_quantize(img) / np.float32(255.0)):
            raise AssertionError(f"{ppm_path}: write_ppm/read_ppm round trip")
        log(f"  write_ppm -> read_ppm {ppm_path}: equal")
    # the mesh-scale oracle config: parsed and built on the card (its
    # bdpt integrator comes with ROADMAP item 12b)
    t0 = time.perf_counter()
    pc = parse_config(root_path("golden", "mesh_bdpt_128.txt"))
    parse_s = time.perf_counter() - t0
    scene = pc.builder.build(device=dev)
    cam = pc.camera(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - parse_s
    if scene.n_tris != 18244 or scene.clusters is None:
        raise AssertionError("mesh_bdpt_128: unexpected scene")
    log(f"golden/mesh_bdpt_128.txt: parsed in {parse_s:.2f} s, scene with "
        f"cluster tables built on the card in {build_s:.2f} s "
        f"({scene.n_tris} triangles, {scene.n_lights} lights, "
        f"{cam.width}x{cam.height}, integrator {pc.integrator})")
    return errs


# ------------------------------------------------------------------ phase 15

def against_integrator_reference(name: str, dev):
    """One stored JAX render (``tests/data/torch_<name>_jax_ref.npz``, made
    by ``tests/data/make_torch_{mesh,integrator}_refs.py``) rendered on the
    card as the file's ``case`` says, at the CPU tests' bar; a compacted
    render's overflow count equal to JAX's."""
    from tuturenderer_tpu_torch.integrators import bdpt, light, naive, path
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    ref, case = stored_reference(name)
    make = {"simple_box": simple_box, "sphere_showcase": sphere_showcase,
            "translucent_showcase": translucent_showcase}[case["scene"]]
    scene, cam = make(*case["size"], **case["scene_kw"], device=dev)
    opts = RenderOptions(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in case["options"].items()})
    run = {"path": path.render, "light": light.render,
           "naivept": naive.render, "bdpt": bdpt.render}[case["integrator"]]
    extra = ""
    if "compaction_overflow" in ref:
        img, st = run(scene, cam, opts, case["seed"], stats=True)
        over, want = int(st["compaction_overflow"]), \
            int(ref["compaction_overflow"])
        extra = f", overflow {over} (JAX {want})"
        if over != want:
            raise AssertionError(f"{name}: overflow {over}, JAX {want}")
    else:
        img = run(scene, cam, opts, case["seed"])
    img, want_img = img.cpu().numpy(), ref["image"]
    close = np.isclose(img, want_img, rtol=1e-4, atol=1e-5).all(axis=-1)
    rel = abs(img.mean() - want_img.mean()) / want_img.mean()
    log(f"{name} ({case['integrator']}, {case['scene']} "
        f"{case['size'][0]}x{case['size'][1]}, {case['options']}): pixels "
        f"within rtol 1e-4 / atol 1e-5: {close.mean() * 100:.2f}% (bar "
        f"99%), image mean {img.mean():.6f} vs {want_img.mean():.6f} (rel "
        f"{rel:.2e}, bar 0.5%){extra}")
    if close.mean() < 0.99 or rel > 0.005:
        raise AssertionError(f"{name}: render disagrees with the JAX "
                             "reference")


def alive_schedule(scene, cam, opts, dev, max_lanes: int = 1 << 18):
    """(live fractions, compaction schedule) as bench.py:127-140 derives
    them: the live-lane fraction entering each bounce of one sample at up
    to max_lanes lanes (the port's trace_rays(collect_alive=True)), times a
    1.5 margin, floored at 0.01."""
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.integrators.path import trace_rays
    n = cam.n_pixels
    lane = torch.arange(0, n, max(1, n // max_lanes), dtype=torch.int32,
                        device=dev)
    o, d, _ = primary_ray(cam, lane % cam.width, lane // cam.width)
    with torch.no_grad():
        _, counts = trace_rays(scene, cam, o, d, lane, 0, 0, opts,
                               collect_alive=True)
    fracs = counts.double().cpu().numpy() / lane.shape[0]
    sched = tuple(float(min(1.0, max(1.5 * f, 0.01))) for f in fracs[:-1])
    return fracs, sched


def timed_path(scene, cam, opts, want: dict, label: str):
    """(image, overflow count, wall) of one path-tracer render with stats,
    its launches held to ``want``."""
    from tuturenderer_tpu_torch.integrators.path import render
    (img, st), wall, launches = timed(
        lambda: render(scene, cam, opts, 0, stats=True))
    over = int(st["compaction_overflow"])
    log(f"  {label}: wall={wall:.3f} s image mean={img.mean().item():.6f} "
        f"overflow={over}")
    check_launches(launches, want)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite pixels")
    return img, over, wall


def phase_compaction(dev) -> dict:
    """Compaction at full width, the kernels against their plain versions
    on the compacted renders' inputs, and against the stored JAX renders.
    Returns the kernels' max abs errors."""
    import dataclasses

    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.tools.time_kernels import (at, capture,
                                                           first_shrunk)
    log("== phase 15.1: compaction at full width: sphere_showcase(512, 512)"
        " x 16 spp in one wavefront (samples_per_launch=16), the schedule "
        "from the live fractions, in turns uncompacted, compacted, "
        "compacted, uncompacted; launches (max_depth + 2) x "
        "spp/samples_per_launch nearest, (max_depth + 1) x that any hit")
    scene, cam = sphere_showcase(512, 512, device=dev)
    base = RenderOptions(spp=16, samples_per_launch=16)
    fracs, sched = alive_schedule(scene, cam, RenderOptions(spp=16), dev)
    comp = dataclasses.replace(base, compaction=sched)
    log(f"live fractions {np.round(fracs, 4).tolist()} -> compaction "
        f"{np.round(sched, 4).tolist()}")
    want = path_launches(base, "cluster_nearest", "cluster_anyhit")
    # warm-up at this wavefront's size (the allocator), not counted; the
    # inputs it gives K5/K6 at the full width (the camera rays, the NEE at
    # their hits; the schedule shrinks before the first bounce) and at the
    # first compacted width
    errs = {}
    with capture(cluster_intersect={"full-width camera rays": at(0),
                                    "first compacted width": first_shrunk},
                 cluster_occluded={"full-width NEE": at(0),
                                   "NEE at the first compacted width":
                                       first_shrunk}) as got:
        timed_path(scene, cam, comp, want, "warm-up, compacted")
    for label in ("full-width", "first compacted width"):
        part = {k: {lab: c for lab, c in v.items()
                    if ("compacted" in lab) == (label != "full-width")}
                for k, v in got.items()}
        merge_errs(errs, compare_captured(f"showcase compacted, {label}",
                                          part))
    del got, part
    got = {}
    for label, opts in (("uncompacted", base), ("compacted", comp),
                        ("compacted", comp), ("uncompacted", base)):
        img, over, wall = timed_path(scene, cam, opts, want, label)
        got.setdefault(label, []).append((img, over, wall))
    a, b = got["uncompacted"][0][0], got["compacted"][0][0]
    over = got["compacted"][0][1]
    diff = (a - b).abs()
    rel = (diff / a.abs().clamp(min=1e-6)).max().item()
    walls = {k: [w for _, _, w in v] for k, v in got.items()}
    log(f"walls: uncompacted {walls['uncompacted']}, compacted "
        f"{walls['compacted']}; compacted vs uncompacted: max |diff| "
        f"{diff.max().item():.3g}, max rel {rel:.3g}, repeat runs "
        f"bit-equal: {bool(torch.equal(a, got['uncompacted'][1][0]))}, "
        f"{bool(torch.equal(b, got['compacted'][1][0]))}")
    if over:
        raise AssertionError(f"the 1.5x schedule overflowed ({over} lanes)")
    # float order only: a lane's radiance is summed in parts, flushed at
    # each shrink
    if not torch.allclose(b, a, rtol=1e-5, atol=1e-6):
        raise AssertionError("compacted showcase differs from uncompacted")
    del scene, cam, a, b, got

    log("== phase 15.2: simple_box(256, 256) x 16 spp under compaction="
        "(1.0, 0.25) (overflow) and (1.0, 1.0); launches (max_depth + 2) x "
        "spp nearest, (max_depth + 1) x spp any hit")
    scene, cam = simple_box(256, 256, device=dev)
    base = RenderOptions(spp=16)
    want = path_launches(base, "nearest", "anyhit")
    plain, _, _ = timed_path(scene, cam, base, want, "uncompacted")
    tight, over, _ = timed_path(
        scene, cam, dataclasses.replace(base, compaction=(1.0, 0.25)), want,
        "compaction=(1.0, 0.25)")
    _, over0, _ = timed_path(
        scene, cam, dataclasses.replace(base, compaction=(1.0, 1.0)), want,
        "compaction=(1.0, 1.0)")
    rel = abs(tight.mean().item() - plain.mean().item()) / \
        plain.mean().item()
    log(f"overflow {over} (> 0), mean off by {rel:.4f} (bar 0.05), roomy "
        f"overflow {over0} (0)")
    if not (over > 0 and rel < 0.05 and over0 == 0):
        raise AssertionError("compaction overflow contract broken")
    # K1/K2 on the shrunk dense wavefront: one sample, not timed
    with capture(tri_intersect={"first compacted width": first_shrunk},
                 tri_occluded={"NEE at the first compacted width":
                               first_shrunk}) as got:
        timed_path(scene, cam, dataclasses.replace(
            base, spp=1, compaction=(1.0, 0.25)),
            path_launches(dataclasses.replace(base, spp=1), "nearest",
                          "anyhit"), "compaction=(1.0, 0.25), 1 spp")
    merge_errs(errs, compare_captured("simple_box compacted", got))
    del got

    log("== phase 15.3: the translucent showcase 256^2 x 4 spp with "
        "alpha_shadows under a compaction schedule (K7 on a shrunk "
        "wavefront); launches (max_depth + 2) x spp nearest, "
        "(max_depth + 1) x spp transmittance")
    scene, cam = translucent_showcase(256, 256, device=dev)
    base = RenderOptions(spp=4, alpha_shadows=True)
    _, sched = alive_schedule(scene, cam, base, dev)
    want = path_launches(base, "cluster_nearest", "cluster_transmit")
    plain, _, _ = timed_path(scene, cam, base, want, "uncompacted")
    comp = dataclasses.replace(base, compaction=sched)
    img, over, _ = timed_path(scene, cam, comp, want,
                              f"compaction={np.round(sched, 4).tolist()}")
    log(f"compacted vs uncompacted: max |diff| "
        f"{(img - plain).abs().max().item():.3g}")
    if over:
        raise AssertionError(f"the 1.5x schedule overflowed ({over} lanes)")
    if not torch.allclose(img, plain, rtol=1e-5, atol=1e-6):
        raise AssertionError("compacted alpha render differs")
    # K5 and K7 (and K6) on the shrunk wavefront, K7 on the scene's own
    # alphas: one more compacted render, not timed
    with capture(cluster_intersect={"first compacted width": first_shrunk},
                 cluster_transmittance={"shadow rays at the first "
                                        "compacted width": first_shrunk}
                 ) as got:
        timed_path(scene, cam, comp, want, "compacted, captured")
    merge_errs(errs, compare_captured("translucent compacted", got,
                                      alpha_cl=scene.clusters))
    del got

    log("== phase 15.4: compacted renders against the stored JAX renders")
    for name in ("compact-mis", "compact-overflow"):
        against_integrator_reference(name, dev)
    return errs


# ------------------------------------------------------------------ phase 16

def phase_light_naive(dev) -> dict:
    """Light tracing and naive PT at full width, the kernels against their
    plain versions on each render's inputs, the CHECK_LT pass, and against
    the stored JAX renders. Returns the kernels' max abs errors."""
    import dataclasses

    from tuturenderer_tpu_torch.integrators import light, naive
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.tools.time_kernels import at, capture
    log("== phase 16: light tracing and naive PT: simple_box(1024, 1024) "
        "and sphere_showcase(512, 512) (lt_max_depth 4) at 16 spp; "
        "launches per sample: light (max(lt_max_depth, 2) - 1) nearest and "
        "max(lt_max_depth, 2) any hit, naive (max(lt_max_depth, 2) - 1) "
        "nearest")
    # warm-up at a small size (lazy module loads); not counted
    s_small, c_small = simple_box(32, 32, device=dev)
    light.render(s_small, c_small, RenderOptions(spp=1))
    naive.render(s_small, c_small, RenderOptions(spp=1))
    scenes = {"simple_box": (lambda: simple_box(1024, 1024, device=dev),
                             RenderOptions(spp=16), ("nearest", "anyhit")),
              "sphere_showcase": (
                  lambda: sphere_showcase(512, 512, device=dev),
                  RenderOptions(spp=16, lt_max_depth=4),
                  ("cluster_nearest", "cluster_anyhit"))}
    errs = {}
    for key, (make, opts, (near, occ)) in scenes.items():
        scene, cam = make()
        steps = max(opts.lt_max_depth, 2) - 1
        # the inputs one sample of each gives the kernels (not timed): the
        # light walk's first nearest hits, its direct (light to camera)
        # and first connection shadow rays; the naive walk's last step
        wrappers = ("tri_intersect", "tri_occluded") if near == "nearest" \
            else ("cluster_intersect", "cluster_occluded")
        one = dataclasses.replace(opts, spp=1)
        for name, mod, picks in (
                ("light", light, {wrappers[0]: {"walk step 1": at(0)},
                                  wrappers[1]: {"direct": at(0),
                                                "connection 1": at(1)}}),
                ("naivept", naive, {wrappers[0]: {
                    f"walk step {steps}": at(steps - 1)}})):
            with capture(**picks) as got:
                mod.render(scene, cam, one, 0)
            merge_errs(errs, compare_captured(f"{name} {key}", got))
            del got
        for name, mod, want in (
                ("light", light, {near: opts.spp * steps,
                                  occ: opts.spp * (steps + 1)}),
                ("naivept", naive, {near: opts.spp * steps})):
            img, wall, launches = timed(
                lambda: mod.render(scene, cam, opts, 0))
            paths = cam.n_pixels * opts.spp
            log(f"{name} {key} {cam.width}x{cam.height} x {opts.spp} spp: "
                f"wall={wall:.3f} s, {paths / wall / 1e6:.3f} Mpaths/s, "
                f"image mean {img.mean().item():.6f}")
            check_launches(launches, want)
            if not bool(torch.isfinite(img).all()) or \
                    tuple(img.shape) != (cam.height, cam.width, 3):
                raise AssertionError(f"{name} {key}: bad image")
        err = light.raster_roundtrip_error(scene, cam).item()
        check = light.raster_check(scene, cam, opts)
        log(f"raster_roundtrip_error {key}: {err:.6f}; raster_check image "
            f"mean {check.mean().item():.6f}")
        del scene, cam
    # the CHECK_LT pass at 24x20: the card against the CPU
    for key, make in (("simple_box", simple_box),
                      ("sphere_showcase", lambda w, h, device: sphere_showcase(
                          w, h, nu=46, nv=46, device=device))):
        rt = [float(light.raster_roundtrip_error(*make(*REF_SIZE,
                                                       device=d)))
              for d in (dev, "cpu")]
        log(f"raster_roundtrip_error {key} 24x20: card {rt[0]:.6f}, CPU "
            f"{rt[1]:.6f}")
        if abs(rt[0] - rt[1]) > 2.0 / (REF_SIZE[0] * REF_SIZE[1]):
            raise AssertionError(f"{key}: raster round trip differs")
    log("== phase 16.2: light and naive renders against the stored JAX "
        "renders")
    for name in ("lt-box", "naive-box", "lt-showcase", "naive-showcase"):
        against_integrator_reference(name, dev)
    return errs


# ------------------------------------------------------------------ phase 17

# wavefront widths of the full-width BDPT renders: one sample of simple_box
# 1024^2 (1,048,576 lanes) and 4 of sphere_showcase 512^2 a launch; a BDPT
# lane holds ~16 KB of device memory at its peak (15 vertices, 27 queued
# strategies; NVIDIA H100 80GB HBM3, 700 W, phase 17)
BDPT_SPL = {"simple_box": 1, "sphere_showcase": 4}


def bdpt_launches(opts, nearest: str, shadow: str) -> dict:
    """A BDPT render's launches: per wavefront bdpt_max_path_length eye
    steps and bdpt_max_path_length - 1 light steps, one nearest hit each,
    and one shadow call over every strategy's connection rays."""
    batches = opts.spp // max(1, opts.samples_per_launch)
    return {nearest: (2 * opts.bdpt_max_path_length - 1) * batches,
            shadow: batches}


def bdpt_errs(name: str, opts, wrappers, wavefront) -> dict:
    """K1/K2 or K5/K6 against their plain versions on the inputs that
    ``wavefront()``, one BDPT wavefront of the main path at its own width
    (one more call, not timed), gives them: the eye walk's second
    nearest-hit call, the light walk's first, and the single shadow call
    over the 27 x n connection rays."""
    from tuturenderer_tpu_torch.tools.time_kernels import at, capture
    near, occ = wrappers
    steps = opts.bdpt_max_path_length
    with capture(**{near: {"eye step 2": at(1),
                           "light step 1": at(steps)},
                    occ: {"connections": at(0)}}) as got:
        wavefront()
    errs = {}
    for label, shadows in (("eye step 2", True), ("light step 1", False)):
        part = {near: {label: got[near][label]}}
        if shadows:
            part[occ] = got[occ]
        merge_errs(errs, compare_captured(f"bdpt {name}", part))
    return errs


def phase_bdpt(dev) -> dict:
    """BDPT at full width on both routes, each kernel against its plain
    version on BDPT's own inputs, and one wavefront's device busy share.
    Returns the kernels' max abs errors."""
    import dataclasses

    from tuturenderer_tpu_torch.integrators import bdpt
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    log("== phase 17: BDPT at full width: simple_box(1024, 1024) and "
        "sphere_showcase(512, 512) x 16 spp at bdpt_max_path_length 7; "
        "launches per wavefront 13 nearest hits (7 eye, 6 light steps) and "
        "one any hit over the 27 strategies' connection rays")
    # warm-up at a small size (lazy module loads); not counted
    s_small, c_small = simple_box(32, 32, device=dev)
    bdpt.render(s_small, c_small, RenderOptions(spp=1))
    cases = {"simple_box": (lambda: simple_box(1024, 1024, device=dev),
                            ("tri_intersect", "tri_occluded"),
                            ("nearest", "anyhit")),
             "sphere_showcase": (
                 lambda: sphere_showcase(512, 512, device=dev),
                 ("cluster_intersect", "cluster_occluded"),
                 ("cluster_nearest", "cluster_anyhit"))}
    errs = {}
    for key, (make, wrappers, (near, occ)) in cases.items():
        scene, cam = make()
        opts = RenderOptions(spp=16, samples_per_launch=BDPT_SPL[key])
        one = dataclasses.replace(opts, spp=opts.samples_per_launch)
        merge_errs(errs, bdpt_errs(key, opts, wrappers, lambda: bdpt.render(
            scene, cam, one, 0)))
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        img, wall, launches = timed(lambda: bdpt.render(scene, cam, opts, 0))
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        paths = cam.n_pixels * opts.spp
        log(f"bdpt {key} {cam.width}x{cam.height} x {opts.spp} spp, "
            f"samples_per_launch {opts.samples_per_launch} "
            f"({cam.n_pixels * opts.samples_per_launch} lanes a wavefront): "
            f"wall={wall:.3f} s, {paths / wall / 1e6:.3f} Mpaths/s, peak "
            f"device memory above the scene {peak:.3f} GB, image mean "
            f"{img.mean().item():.6f}")
        check_launches(launches, bdpt_launches(opts, near, occ))
        if not bool(torch.isfinite(img).all()) or \
                tuple(img.shape) != (cam.height, cam.width, 3):
            raise AssertionError(f"bdpt {key}: bad image")
        KEPT[f"bdpt {key}"] = img.cpu().numpy()
        wall1, busy, top = device_share(lambda: bdpt.render(scene, cam, one,
                                                            0))
        log(f"  one wavefront under the profiler: wall {wall1:.3f} s, device "
            f"busy {busy:.3f} s ({busy / wall1 * 100:.1f} %); most device "
            "time: " + "; ".join(f"{k} {t:.3f} s x{c}" for k, t, c in top))
        del scene, cam, img
    return errs


# ------------------------------------------------------------------ phase 18

def phase_bdpt_golden(dev):
    """render_config of golden/mesh_bdpt_128.txt (18,244 faces, BDPT
    through K5/K6) at 128x128 x 64 spp, 16 a wavefront, oracle quirks,
    seeds 9 and 23, against the reference renderer's image with
    tests/test_golden.py's compare and its bars for this config."""
    from tuturenderer_tpu_torch.io.ppm import read_ppm
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.render import render_config
    log("== phase 18: render_config of golden/mesh_bdpt_128.txt at 128x128 "
        "x 64 spp (samples_per_launch 16, oracle quirk profile) against "
        "golden/mesh_bdpt_128_ref.ppm")
    opts = RenderOptions(spp=64, samples_per_launch=16, **ORACLE)
    golden = read_ppm(root_path("golden", "mesh_bdpt_128_ref.ppm"))
    for seed in GOLDEN_SEEDS:
        img, wall, launches = timed(lambda: render_config(
            root_path("golden", "mesh_bdpt_128.txt"), opts, seed=seed,
            verbose=False, device=dev))
        log(f"mesh_bdpt_128.txt seed {seed}: wall={wall:.3f} s")
        check_launches(launches, bdpt_launches(opts, "cluster_nearest",
                                               "cluster_anyhit"))
        if img.shape != golden.shape or not np.isfinite(img).all():
            raise AssertionError(f"mesh_bdpt_128: image {img.shape}")
        ours = quantize(img)
        blk = np.abs(block_mean(golden, 8) - block_mean(ours, 8)).max()
        log(f"  against golden/mesh_bdpt_128_ref.ppm: max 8x8 block diff "
            f"{blk:.5f} (bar 0.1), mean abs diff "
            f"{np.abs(golden - ours).mean():.5f} (bar 0.04), mean diff "
            f"{abs(golden.mean() - ours.mean()):.5f} (bar 0.012); image "
            f"mean {img.mean():.6f}")
        compare(golden, ours, 8, 0.1, 0.04, 0.012)


# ------------------------------------------------------------------ phase 19

def phase_bdpt_references(dev):
    log("== phase 19: BDPT renders against the stored JAX renders")
    for name in ("bdpt-box", "bdpt-showcase", "bdpt-showcase-quirks-off",
                 "bdpt-showcase-7"):
        against_integrator_reference(name, dev)


# ------------------------------------------------------------------ phase 20

def train_phase(name: str, renderer: str, make, spps, want):
    """Forward and backward of mean(``renderer``) at each spp of ``spps``
    (launches held to ``want(spp)``), the peak memory at each, which must
    not grow with spp, and a central finite difference of the red wall's
    diffuse red channel (material 1, leaf 0) at the largest. Returns the
    scene and camera."""
    from tuturenderer_tpu_torch.options import RenderOptions
    scene, cam = make()
    peaks = {}
    for spp in spps:
        opts = RenderOptions(spp=spp)
        img, grads, wall, launches, peak, before = fwd_bwd(
            scene, cam, opts, renderer=renderer)
        check_launches(launches, want(spp))
        peaks[spp] = (peak - before) / 1e9
        log(f"{name} x {spp} spp: forward+backward wall={wall:.3f} s, "
            f"{cam.n_pixels * spp / wall / 1e6:.3f} Mpaths/s, peak device "
            f"memory above the scene {peaks[spp]:.3f} GB, image mean "
            f"{img.mean().item():.6f}")
    if peaks[spps[-1]] > 1.5 * peaks[spps[0]]:
        raise AssertionError(f"{name}: peak memory grows with spp")
    fd_check(name, scene, cam, opts, 1, 0, 1, float(grads[0][1]),
             renderer=renderer)
    return scene, cam


def phase_bdpt_train(dev) -> dict:
    """The light tracer's and BDPT's gradients, and K1/K2 against their
    plain versions on one forward sample of render_bdpt_diff. Returns the
    kernels' max abs errors."""
    from tuturenderer_tpu_torch import grad
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    # warm-up at a small size (lazy module loads); not counted
    for renderer in ("render_light_diff", "render_bdpt_diff"):
        fwd_bwd(*simple_box(32, 32, device=dev), RenderOptions(spp=1),
                renderer=renderer)
    log("== phase 20: forward+backward of mean(render_light_diff("
        "simple_box(1024, 1024))) at 2 and 8 spp and of mean("
        "render_bdpt_diff(simple_box(512, 512))) at 1 and 4 spp (K1/K2; "
        "the backward pass replays each sample once), then the card's "
        "gradients against the stored JAX gradients")
    train_phase("render_light_diff simple_box 1024^2", "render_light_diff",
                lambda: simple_box(1024, 1024, device=dev), (2, 8),
                lambda spp: {"nearest": 2 * spp, "anyhit": 4 * spp})
    scene, cam = train_phase(
        "render_bdpt_diff simple_box 512^2", "render_bdpt_diff",
        lambda: simple_box(512, 512, device=dev), (1, 4),
        lambda spp: {"nearest": 26 * spp, "anyhit": 2 * spp})
    one = RenderOptions(spp=1)
    errs = bdpt_errs("render_bdpt_diff simple_box 512^2", one,
                     ("tri_intersect", "tri_occluded"),
                     lambda: grad.render_bdpt_diff(grad.get_params(scene),
                                                   scene, cam, one, 1))
    for name in ("lt-diffuse", "bdpt-diffuse"):
        against_grad_reference(name, dev)
    return errs


# ------------------------------------------------------------------ phase 21

SHELL_SPP = 64
# tests/test_cli.py's INVERT_CONFIG at 128x128: a wall facing the camera
# under a downward-facing area light
INVERT_CONFIG = """\
imsize 128 128
eye 0 0 3
viewdir 0 0 -1
hfov 60
updir 0 1 0
bkgcolor 0 0 0 1.0
integrator path

mtlcolor 0.8 0.2 0.2 1 1 1 1.0 1.0
v -2 -2 -1
v 2 -2 -1
v 0 2 -1
f 1 2 3

emission 8 8 8
v -0.5 0.9 0.5
v 0 0.9 -0.5
v 0.5 0.9 0.5
f 4 5 6
"""


def ref_gauss_weights():
    """tests/test_post.py's transcription of Postprocessor.hpp:77-80 (the
    sqrt(2*pi*sigma) quirk and the truncated E constant), float64."""
    from tuturenderer_tpu_torch.post import KERNELSIZE, STDDEV
    e = 2.7182818
    start = int(-KERNELSIZE * 0.5)
    xs = np.arange(start, start + KERNELSIZE, dtype=np.float64)
    w = (1.0 / np.sqrt(2 * np.pi * STDDEV)) * e ** (
        -(xs * xs) / (2 * STDDEV * STDDEV))
    return xs.astype(int), w


def ref_blur_once(img):
    """tests/test_post.py's getGaussianBlurTexture (Postprocessor.hpp:
    63-119): vertical then horizontal, clamp-to-edge, normalised."""
    offs, w = ref_gauss_weights()
    h, wd, _ = img.shape
    out = np.zeros_like(img)
    for i, off in enumerate(offs):
        out += w[i] * img[np.clip(np.arange(h) + off, 0, h - 1), :, :]
    out /= w.sum()
    out2 = np.zeros_like(out)
    for i, off in enumerate(offs):
        out2 += w[i] * out[:, np.clip(np.arange(wd) + off, 0, wd - 1), :]
    return out2 / w.sum()


def ref_pipeline(img):
    """tests/test_post.py::ref_pipeline: bloom of the emissive extract,
    then the exposure tone map, in float64."""
    from tuturenderer_tpu_torch.post import EXPOSURE, GAUSSIANLOOP, STRENGTH
    norm = np.sqrt((img ** 2).sum(-1, keepdims=True))
    mx = img.max(-1, keepdims=True)
    em = np.where(norm > 3.0, img / np.maximum(mx, 1e-20) * STRENGTH, 0.0)
    for _ in range(GAUSSIANLOOP + 1):
        em = ref_blur_once(em)
    return 1.0 - np.exp(-(img + em) * EXPOSURE)


def run_cli(argv):
    """(stdout and stderr text, wall s, kernel launches) of one in-process
    ``cli.main(argv)`` call, the launch counts zeroed just before it."""
    import io

    from tuturenderer_tpu_torch.cli import main as cli_main
    text = io.StringIO()
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(text):
        _, wall, launches = timed(lambda: cli_main(argv))
    return text.getvalue(), wall, launches


def ppm_levels(path: str) -> np.ndarray:
    from tuturenderer_tpu_torch.io.ppm import read_ppm
    return np.rint(read_ppm(path) * 255.0).astype(np.int32)


def same_write(name: str, got: np.ndarray, img: np.ndarray):
    """8-bit ``got`` against ``img`` through the same write (clamp, gamma,
    truncation): within one level everywhere and equal on >= 99.9 % of
    the values (the card's splat ``index_add_`` is not deterministic)."""
    from tuturenderer_tpu_torch.io.ppm import quantize
    want = quantize(np.asarray(img)).astype(np.int32)
    diff = np.abs(got - want)
    equal = float((diff == 0).mean())
    log(f"  {name}: 8-bit values equal {equal * 100:.3f} % (bar 99.9 %), "
        f"max difference {int(diff.max())} level(s) (bar 1)")
    if got.shape != want.shape or diff.max() > 1 or equal < 0.999:
        raise AssertionError(f"{name}: written image disagrees")


def path_render_launches(opts, dense: bool = True) -> dict:
    """path_launches on a dense or cluster scene; the NEE-only estimator
    (mis=False) has no epilogue, so one nearest hit less a wavefront."""
    out = path_launches(opts, "nearest" if dense else "cluster_nearest",
                        "anyhit" if dense else "cluster_anyhit")
    if not opts.mis:
        near = "nearest" if dense else "cluster_nearest"
        out[near] -= opts.spp // max(1, opts.samples_per_launch)
    return out


def walk_launches(integrator: str, opts, samples: int) -> dict:
    """Launches of ``samples`` light-tracing or naive-PT samples on a dense
    scene: (max(lt_max_depth, 2) - 1) nearest hits each, and for the light
    tracer max(lt_max_depth, 2) any hits."""
    steps = max(opts.lt_max_depth, 2)
    out = {"nearest": (steps - 1) * samples}
    if integrator == "light":
        out["anyhit"] = steps * samples
    return out


def integrator_launches(integrator: str, opts) -> dict:
    """A dense scene's render of ``opts`` with ``integrator``."""
    if integrator == "path":
        return path_render_launches(opts)
    if integrator == "bdpt":
        return bdpt_launches(opts, "nearest", "anyhit")
    return walk_launches(integrator, opts, opts.spp)


def phase_cli(dev):
    """The shell on the card: the CLI on the golden configs against
    render_config, interrupted checkpoints of all four integrators, the
    estimator grid, the post pass, the profiler trace and --invert."""
    from tuturenderer_tpu_torch.cli import samples_per_launch
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.render import render_config
    from tuturenderer_tpu_torch.scene.config import parse_config
    log("== phase 21: the shell on the card: python -m "
        "tuturenderer_tpu_torch (cli.main in this process) on golden/"
        "mft_128.txt, tex_128.txt and mesh_bdpt_128.txt at 128x128 x "
        f"{SHELL_SPP} spp ({samples_per_launch(SHELL_SPP, 128 * 128)} "
        "samples a wavefront), "
        "--checkpoint, --estimator-grid, --post, --profile --trace-dir and "
        "--invert")
    out_dir = root_path("build", "chip_smoke", "cli")
    os.makedirs(out_dir, exist_ok=True)
    opts = RenderOptions(spp=SHELL_SPP, samples_per_launch=samples_per_launch(
        SHELL_SPP, 128 * 128))
    configs = {"mft_128": golden_config("mft_128.txt", out_dir),
               "tex_128": golden_config("tex_128.txt", out_dir),
               "mesh_bdpt_128": root_path("golden", "mesh_bdpt_128.txt")}
    for name, path in configs.items():
        out = os.path.join(out_dir, f"{name}.ppm")
        text, wall, launches = run_cli([path, "--spp", str(SHELL_SPP), "-o",
                                        out])
        bdpt = name == "mesh_bdpt_128"
        log(f"cli {name}: wall={wall:.3f} s, "
            f"{128 * 128 * SHELL_SPP / wall / 1e6:.3f} Mpaths/s; launches "
            + ("(2 bdpt_max_path_length - 1) nearest and 1 any hit a "
               "wavefront:" if bdpt else "(max_depth + 2) nearest and "
               "(max_depth + 1) any hit a wavefront:"))
        check_launches(launches, bdpt_launches(
            opts, "cluster_nearest", "cluster_anyhit") if bdpt
            else path_render_launches(opts))
        if "Generating image successfully" not in text:
            raise AssertionError(f"cli {name}: {text[-400:]}")
        img = render_config(path, opts, seed=0, verbose=False, device=dev)
        same_write(f"cli {name} against render_config", ppm_levels(out), img)

    mft = configs["mft_128"]
    pc = parse_config(mft)
    scene, cam = pc.builder.build(device=dev), pc.camera(device=dev)
    for part in (cli_checkpoints, cli_grid, cli_post):
        part(dev, mft, scene, cam, opts, out_dir)
    cli_trace(mft, out_dir)
    cli_invert(out_dir)


def cli_checkpoints(dev, mft: str, scene, cam, opts, out_dir: str):
    """--checkpoint for each integrator: 32 spp, then resumed to 64 in
    16-spp chunks, held to the single-shot render."""
    import dataclasses

    from tuturenderer_tpu_torch.render import render_image, render_progressive

    resumed = dataclasses.replace(opts, spp=SHELL_SPP // 2,
                                  samples_per_launch=16)
    for integrator in ("path", "light", "naivept", "bdpt"):
        ck = os.path.join(out_dir, f"checkpoint_{integrator}.npz")
        if os.path.exists(ck):
            os.remove(ck)
        args = ["--chunk-spp", "16", "--checkpoint", ck, "--integrator",
                integrator, "-o",
                os.path.join(out_dir, f"ck_{integrator}.ppm")]
        run_cli([mft, "--spp", str(SHELL_SPP // 2), *args])
        if int(np.load(ck)["spp_done"]) != SHELL_SPP // 2:
            raise AssertionError(f"{integrator}: checkpoint not at 32 spp")
        text, wall, launches = run_cli([mft, "--spp", str(SHELL_SPP), *args])
        if f"resumed at {SHELL_SPP // 2}/{SHELL_SPP} spp" not in text:
            raise AssertionError(f"{integrator}: did not resume: {text}")
        log(f"cli --checkpoint --integrator {integrator}: resumed at 32 of 64 "
            f"spp, the second half in {wall:.3f} s; launches of its two "
            "16-spp chunks:")
        check_launches(launches, integrator_launches(integrator, resumed))
        if int(np.load(ck)["spp_done"]) != SHELL_SPP:
            raise AssertionError(f"{integrator}: checkpoint not at 64 spp")
        prog = render_progressive(scene, cam, opts, integrator, seed=0,
                                  chunk_spp=16, checkpoint_path=ck,
                                  progress=False)
        one = render_image(scene, cam, opts, integrator, seed=0)
        err = float(np.max(np.abs(prog - one) / (2e-6 + 2e-4 * np.abs(one))))
        log(f"  resumed film against the single-shot render_image: worst "
            f"|diff| / (2e-6 + 2e-4 |want|) = {err:.4f} (bar 1)")
        np.testing.assert_allclose(prog, one, rtol=2e-4, atol=2e-6,
                                   err_msg=integrator)
        same_write(f"  its PPM against the resumed film",
                   ppm_levels(os.path.join(out_dir, f"ck_{integrator}.ppm")),
                   prog)


def cli_grid(dev, mft: str, scene, cam, opts, out_dir: str):
    """--estimator-grid, each pane against its own render_image."""
    import dataclasses

    from tuturenderer_tpu_torch.render import render_image
    out = os.path.join(out_dir, "grid.ppm")
    _, wall, launches = run_cli([mft, "--spp", str(SHELL_SPP),
                                 "--estimator-grid", "-o", out])
    panes = (("naivept", opts), ("light", opts),
             ("path", dataclasses.replace(opts, mis=False)),
             ("path", dataclasses.replace(opts, mis=True)))
    want = {}
    for integrator, o in panes:
        merge_launches(want, integrator_launches(integrator, o))
    log(f"cli --estimator-grid: wall={wall:.3f} s; launches naive + light "
        "+ NEE (no epilogue) + MIS panes:")
    check_launches(launches, want)
    grid = ppm_levels(out)
    h, w = cam.height, cam.width
    for i, (integrator, o) in enumerate(panes):
        r, c = divmod(i, 2)
        same_write(f"grid pane {i} ({integrator}, mis={o.mis}) against its "
                   "render_image", grid[r * h:(r + 1) * h, c * w:(c + 1) * w],
                   render_image(scene, cam, o, integrator, seed=0))


def cli_post(dev, mft: str, scene, cam, opts, out_dir: str):
    """--post against the float64 formula of the unprocessed render."""
    from tuturenderer_tpu_torch.post import bloom_and_tonemap
    from tuturenderer_tpu_torch.render import render_image
    out = os.path.join(out_dir, "post.ppm")
    run_cli([mft, "--spp", str(SHELL_SPP), "--post", "-o", out])
    lin = render_image(scene, cam, opts, seed=0)
    want = ref_pipeline(lin.astype(np.float64))
    on_card = bloom_and_tonemap(torch.from_numpy(lin).to(dev)).cpu().numpy()
    err = float(np.max(np.abs(on_card - want) / (1e-6 + 2e-4 * np.abs(want))))
    log(f"post.bloom_and_tonemap on the card against test_post.py's float64 "
        f"ref_pipeline of the unprocessed render: worst |diff| / (1e-6 + "
        f"2e-4 |want|) = {err:.4f} (bar 1)")
    np.testing.assert_allclose(on_card, want, rtol=2e-4, atol=1e-6)
    same_write("cli --post against the post pass of the unprocessed render",
               ppm_levels(out), on_card)


def cli_trace(mft: str, out_dir: str):
    """--profile --trace-dir: the phase table, M paths/s, and a trace with
    records of every hand-written kernel the render launched."""
    trace_dir = root_path("build", "chip_smoke", "trace")
    text, wall, launches = run_cli([mft, "--spp", "4", "--profile",
                                    "--trace-dir", trace_dir, "-o",
                                    os.path.join(out_dir, "profile.ppm")])
    for line in text.splitlines():
        if "paths" in line or line.startswith("  "):
            log(f"  {line.strip()}")
    if "M paths/s" not in text or "scene build" not in text:
        raise AssertionError(f"cli --profile: {text[-400:]}")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    kept = {k: sum(KERNEL_NAMES[k] in n for n in kernels)
            for k, n_launched in launches.items() if n_launched}
    log(f"cli --profile --trace-dir: {len(events)} trace events, "
        f"{len(kernels)} kernel records; records of the hand-written kernels "
        f"the render launched (kept / launched): "
        f"{ {k: (kept[k], launches[k]) for k in kept} }")
    if not kept or not all(kept.values()):
        raise AssertionError("the trace lacks a launched kernel")


def cli_invert(out_dir: str):
    """--invert: 40 steps from a wrong albedo, the loss below 0.05 of its
    first."""
    true_cfg = os.path.join(out_dir, "invert_true.txt")
    wrong_cfg = os.path.join(out_dir, "invert_wrong.txt")
    with open(true_cfg, "w") as f:
        f.write(INVERT_CONFIG)
    with open(wrong_cfg, "w") as f:
        f.write(INVERT_CONFIG.replace("mtlcolor 0.8 0.2 0.2",
                                      "mtlcolor 0.2 0.6 0.7"))
    args = ["--spp", "4", "--max-depth", "2"]
    target = os.path.join(out_dir, "invert_target.ppm")
    run_cli([true_cfg, *args, "-o", target])
    text, wall, launches = run_cli([
        wrong_cfg, *args, "--invert", target, "--invert-steps", "40",
        "--invert-lr", "10.0", "-o", os.path.join(out_dir, "recovered.ppm")])
    losses = [float(ln.split("loss")[1]) for ln in text.splitlines()
              if ln.startswith("invert step")]
    log(f"cli --invert at 128x128 x 4 spp, 40 steps: wall={wall:.3f} s "
        f"(the final render included); losses at steps 0, 10, 20, 30, 39: "
        f"{losses}; " + "; ".join(ln for ln in text.splitlines()
                                  if "diffuse =" in ln))
    # a step's forward and backward: (3 (max_depth + 1) + 2) nearest hits
    # and 3 (max_depth + 1) any hits (phase 9's count); then one render
    depth = 2 + 1
    log("  launches 40 steps x (3 (max_depth + 1) + 2) nearest and "
        "3 (max_depth + 1) any hit, + the final render's (max_depth + 2) "
        "and (max_depth + 1):")
    check_launches(launches, {"nearest": 40 * (3 * depth + 2) + depth + 1,
                              "anyhit": 40 * 3 * depth + depth})
    if len(losses) != 5 or not losses[-1] < 0.05 * losses[0]:
        raise AssertionError(f"--invert: loss {losses}")


def merge_launches(into: dict, more: dict):
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


# ------------------------------------------------------------------ phase 22

# images of earlier phases that phase 22 holds the sharded renders to:
# phase 4's simple_box, phase 7's sphere_showcase and translucent showcase,
# phase 17's BDPT simple_box (host copies)
KEPT: dict = {}
GLOO_SIZE = (256, 256)
GLOO_SPP = 16
GLOO_MESHES = {"tile 2 x sample 1": (2, 1), "tile 1 x sample 2": (1, 2)}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def held_to(name: str, got, want, rtol: float = 2e-5, atol: float = 2e-6):
    """A sharded image against the single-device one at
    tests/test_sharding.py's bar."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))
    log(f"  {name}: worst |diff| / ({atol:g} + {rtol:g} |want|) = {err:.4f} "
        "(bar 1)")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


def sharded_render(name: str, fn, cam, opts, want_launches: dict, formula):
    """(image, wall) of one sharded render, its launches held to
    ``want_launches`` and logged with ``formula``."""
    img, wall, launches = timed(fn)
    paths = cam.n_pixels * opts.spp
    log(f"{name}: wall={wall:.3f} s, {paths / wall / 1e6:.3f} Mpaths/s; "
        f"launches {formula}:")
    check_launches(launches, want_launches)
    if not bool(torch.isfinite(img).all()) or \
            tuple(img.shape) != (cam.height, cam.width, 3):
        raise AssertionError(f"{name}: bad image")
    return img


def gloo_rank(rank: int, port: int, out_dir: str):
    """One of two ranks on the one card in a gloo group: simple_box
    GLOO_SIZE x GLOO_SPP spp through render_sharded on each GLOO_MESHES
    mesh; saves the images and each render's launches."""
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.parallel import distributed as D
    from tuturenderer_tpu_torch.parallel.sharding import render_sharded
    from tuturenderer_tpu_torch.scene.presets import simple_box
    torch.cuda.set_device(0)
    D.init_distributed(f"127.0.0.1:{port}", 2, rank)
    out = {"backend": np.asarray(D.dist.get_backend())}
    try:
        scene, cam = simple_box(*GLOO_SIZE, device="cuda")
        opts = RenderOptions(spp=GLOO_SPP)
        for label, shape in GLOO_MESHES.items():
            mesh = D.new_mesh(("tile", "sample"), shape)
            img, wall, launches = timed(lambda: render_sharded(
                scene, cam, opts, mesh, seed=0))
            out[f"{label}/image"] = img.cpu().numpy()
            out[f"{label}/wall"] = np.asarray(wall)
            out[f"{label}/launches"] = np.asarray(
                [launches["nearest"], launches["anyhit"]])
    finally:
        D.dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"gloo_rank{rank}.npz"), **out)


def phase_gloo(dev):
    """Two ranks on the one card through gloo (NCCL takes one rank a
    device), each mesh held to the single-device render."""
    import torch.multiprocessing as mp

    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    log(f"== phase 22.2: two ranks on the one card, a gloo group (spawned "
        f"processes): render_sharded(simple_box{GLOO_SIZE}, "
        f"RenderOptions(spp={GLOO_SPP})) as " + " and ".join(GLOO_MESHES))
    out_dir = root_path("build", "chip_smoke", "gloo")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(gloo_rank, args=(free_port(), out_dir),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=10):
            if time.perf_counter() - t0 > 300:
                raise TimeoutError("the gloo ranks still run after 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    log(f"  both ranks done in {time.perf_counter() - t0:.1f} s (process "
        "start, CUDA init and kernel loads included)")
    ranks = [np.load(os.path.join(out_dir, f"gloo_rank{r}.npz"))
             for r in range(2)]
    scene, cam = simple_box(*GLOO_SIZE, device=dev)
    opts = RenderOptions(spp=GLOO_SPP)
    want = render(scene, cam, opts, seed=0).cpu().numpy()
    for label, (n_tile, n_sample) in GLOO_MESHES.items():
        per_rank = GLOO_SPP // n_sample
        for r, got in enumerate(ranks):
            if str(got["backend"]) != "gloo":
                raise AssertionError(f"rank {r}: backend {got['backend']}")
            launches = got[f"{label}/launches"].tolist()
            log(f"  {label}, rank {r}: wall={float(got[f'{label}/wall']):.3f}"
                f" s; launches (max_depth + 2) and (max_depth + 1) x its "
                f"{per_rank} samples: {launches}")
            if launches != [(opts.max_depth + 2) * per_rank,
                            (opts.max_depth + 1) * per_rank]:
                raise AssertionError(f"{label} rank {r}: launches {launches}")
            held_to(f"{label}, rank {r}, against render",
                    got[f"{label}/image"], want)


def phase_sharded(dev) -> dict:
    """The sharded entry points in an NCCL group of world 1 in this
    process, the kernels on a sharded render's inputs, then phase_gloo.
    Returns the kernels' max abs errors."""
    from tuturenderer_tpu_torch.grad import get_params, image_loss_and_grad
    from tuturenderer_tpu_torch.integrators import light
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.parallel import distributed as D
    from tuturenderer_tpu_torch.parallel import sharding as S
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.tools.time_kernels import at, capture
    port = free_port()
    log(f"== phase 22: multi-GPU entry points (parallel/sharding.py) in an "
        f"NCCL group of world 1 (tcp://127.0.0.1:{port}), then two gloo "
        "ranks on the card")
    D.init_distributed(f"127.0.0.1:{port}", 1, 0)
    errs = {}
    try:
        if D.dist.get_backend() != "nccl":
            raise AssertionError(f"backend {D.dist.get_backend()}")
        mesh = S.make_mesh()
        log(f"mesh {mesh.shape}, rank coordinates {mesh.coords}")
        scene, cam = simple_box(1024, 1024, device=dev)
        opts = RenderOptions(spp=64)
        img = sharded_render(
            "render_sharded(simple_box(1024, 1024), RenderOptions(spp=64))",
            lambda: S.render_sharded(scene, cam, opts, mesh, seed=0), cam,
            opts, path_render_launches(opts),
            "(max_depth + 2) nearest, (max_depth + 1) any hit a sample")
        held_to("against phase 4's render", img, KEPT["simple_box"])
        opts = RenderOptions(spp=16)
        img = sharded_render(
            "render_light_sharded(simple_box(1024, 1024), "
            "RenderOptions(spp=16))",
            lambda: S.render_light_sharded(scene, cam, opts, mesh, seed=0),
            cam, opts, walk_launches("light", opts, opts.spp),
            "(max(lt_max_depth, 2) - 1) nearest, max(lt_max_depth, 2) any hit "
            "a sample")
        held_to("against light.render", img,
                light.render(scene, cam, opts, 0).cpu().numpy())
        img = sharded_render(
            "render_bdpt_sharded(simple_box(1024, 1024), "
            "RenderOptions(spp=16))",
            lambda: S.render_bdpt_sharded(scene, cam, opts, mesh, seed=0),
            cam, opts, bdpt_launches(opts, "nearest", "anyhit"),
            "(2 bdpt_max_path_length - 1) nearest, 1 any hit a sample")
        held_to("against phase 17's bdpt.render", img,
                KEPT["bdpt simple_box"])
        # the kernels on the inputs a sharded render gives them
        with capture(tri_intersect={"bounce 1": at(1)},
                     tri_occluded={"NEE at bounce 1": at(1)}) as got:
            S.render_sharded(scene, cam, RenderOptions(spp=1), mesh, seed=0)
        merge_errs(errs, compare_captured("render_sharded simple_box", got))
        del scene, cam, img

        s_mesh, c_mesh = sphere_showcase(512, 512, device=dev)
        img = sharded_render(
            "render_sharded(sphere_showcase(512, 512), RenderOptions(spp=16))",
            lambda: S.render_sharded(s_mesh, c_mesh, opts, mesh, seed=0),
            c_mesh, opts, path_render_launches(opts, dense=False),
            "(max_depth + 2) nearest, (max_depth + 1) any hit a sample")
        held_to("against phase 7's render", img, KEPT["sphere_showcase"])
        with capture(cluster_intersect={"bounce 1": at(1)},
                     cluster_occluded={"NEE at bounce 1": at(1)}) as got:
            S.render_sharded(s_mesh, c_mesh, RenderOptions(spp=1), mesh,
                             seed=0)
        merge_errs(errs, compare_captured("render_sharded sphere_showcase",
                                          got))
        del s_mesh, c_mesh, img
        s_tr, c_tr = translucent_showcase(256, 256, device=dev)
        o_tr = RenderOptions(spp=4, alpha_shadows=True)
        img = sharded_render(
            "render_sharded(translucent showcase(256, 256), "
            "RenderOptions(spp=4, alpha_shadows=True))",
            lambda: S.render_sharded(s_tr, c_tr, o_tr, mesh, seed=0), c_tr,
            o_tr, path_launches(o_tr, "cluster_nearest", "cluster_transmit"),
            "(max_depth + 2) nearest, (max_depth + 1) transmittance a sample")
        held_to("against phase 7's render", img, KEPT["translucent"])
        del s_tr, c_tr, img

        log("train_step_sharded at simple_box(1024, 1024) x 8 spp and "
            "image_loss_and_grad_sharded at 2 spp, Moller-Trumbore form "
            "(K3/K4), against grad.image_loss_and_grad at the same seed")
        with dense_kernel("mt"):
            # warm-up at a small size (allocator, lazy loads); not counted
            s_small, c_small = simple_box(64, 64, device=dev)
            S.image_loss_and_grad_sharded(
                get_params(s_small), torch.zeros((64, 64, 3), device=dev),
                s_small, c_small, RenderOptions(spp=1), mesh)
            scene, cam = simple_box(1024, 1024, device=dev)
            params = get_params(scene)
            target = torch.full((cam.height, cam.width, 3), 0.25, device=dev)
            lr = 0.05
            peaks = {}
            for spp in (2, 8):
                o = RenderOptions(spp=spp)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                if spp == 8:
                    (new, loss), wall, launches = timed(
                        lambda: S.train_step_sharded(params, target, scene,
                                                     cam, o, mesh, lr=lr,
                                                     seed=1))
                else:
                    (loss, g), wall, launches = timed(
                        lambda: S.image_loss_and_grad_sharded(
                            params, target, scene, cam, o, mesh, seed=1))
                peaks[spp] = (torch.cuda.max_memory_allocated() - before) / 1e9
                depth = o.max_depth + 1
                step = "train_step_sharded" if spp == 8 else \
                    "image_loss_and_grad_sharded"
                log(f"  {step} at {spp} spp: wall={wall:.3f} s, "
                    f"{cam.n_pixels * spp / wall / 1e6:.3f} Mpaths/s, peak "
                    f"device memory above the scene {peaks[spp]:.3f} GB; "
                    "launches (3 (max_depth + 1) + 2) and 3 (max_depth + 1) "
                    "a sample:")
                check_launches(launches, {"mt_nearest": (3 * depth + 2) * spp,
                                          "mt_anyhit": 3 * depth * spp})
                want_loss, want_g = image_loss_and_grad(params, target, scene,
                                                        cam, o, seed=1)
                log(f"  loss {float(loss):.8f} against image_loss_and_grad's "
                    f"{float(want_loss):.8f}")
                np.testing.assert_allclose(float(loss), float(want_loss),
                                           rtol=1e-5)
                if spp == 8:
                    # one SGD step: w - lr * g of the single-device gradient
                    for name, a, w, b in zip(GRAD_LEAVES, new.leaves(),
                                             params.leaves(),
                                             want_g.leaves()):
                        np.testing.assert_allclose(
                            a.cpu().numpy(), (w - lr * b).cpu().numpy(),
                            rtol=1e-6, atol=lr * 1e-5 * float(b.abs().max()),
                            err_msg=name)
                    log("  the step equals w - lr * g of the single-device "
                        "gradient")
                    continue
                worst = 0.0
                for name, a, b in zip(GRAD_LEAVES, g.leaves(),
                                      want_g.leaves()):
                    scale = float(b.abs().max())
                    diff = float((a - b).abs().max())
                    worst = max(worst, diff / scale if scale else diff)
                    if diff > 1e-5 * scale:
                        raise AssertionError(f"gradient {name}: {diff} of "
                                             f"{scale}")
                log(f"  gradients within {worst:.2e} of each leaf's largest "
                    "magnitude (bar 1e-5)")
            if peaks[8] > 1.05 * peaks[2]:
                raise AssertionError(f"peak memory grows with spp: {peaks}")
            del scene, cam
    finally:
        D.dist.destroy_process_group()
    phase_gloo(dev)
    return errs


# ------------------------------------------------------------------ phase 23

@contextlib.contextmanager
def plain_route():
    """``ops/intersect.py``'s nearest-hit kernel wrappers replaced by their
    plain versions within the block (K1, K3 and K5's)."""
    from tuturenderer_tpu_torch.ops import intersect as TI
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    plain = {"tri_intersect": K.tri_intersect_plain,
             "tri_intersect_mt": K.tri_intersect_mt_plain,
             "cluster_intersect": C.cluster_intersect_plain}
    saved = {name: getattr(TI, name) for name in plain}
    for name, fn in plain.items():
        setattr(TI, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(TI, name, fn)


def tied(scene, form: str, rays, rec, plain) -> int:
    """Where the two records' idx differ, both triangles must accept the
    ray at the record's t, bit for bit, in the test of the route that
    traced it (K1's Woop rows, K3's MT rows or the cluster rows): an exact
    t tie. So idx is equal wherever t is unique. Returns the number of
    such rays."""
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    diff = torch.nonzero(rec.idx != plain.idx)[:, 0]
    if diff.numel() == 0:
        return 0
    ray = [c[diff] for c in rays]
    if scene.clusters is not None:
        rows, virt = C.real_rows(scene.clusters)
        row_of = torch.empty(scene.n_tris, dtype=torch.int64,
                             device=rows.device)
        row_of[scene.clusters.tri_idx.reshape(-1)[virt].long()] = \
            torch.arange(rows.shape[0], device=rows.device)
        table, test = rows, C._test_tile
    else:
        f = dense_form(form)
        table = f["pack"](scene).reshape(-1, f["floats"])
        row_of, test = None, f["tile"]
    for idx in (rec.idx[diff], plain.idx[diff]):
        if bool((idx < 0).any()):
            raise AssertionError("a hit against a miss where t is equal")
        r = idx.long() if row_of is None else row_of[idx.long()]
        # 1-D rays against one row each: the test pairs them elementwise
        t, _, _, ok = test(table[r], *ray)
        if not bool(ok.all()) or not torch.equal(t[0], rec.t[diff]):
            raise AssertionError("idx differs where t is unique")
    return int(diff.numel())


def hold_record(name: str, scene, form: str, rays, rec, plain) -> float:
    """``intersect_scene``'s record on the card against the plain route's:
    t bit-equal, idx equal where t is unique (``tied``), every other field
    bit-equal where idx is. Returns the max abs error over t and those
    fields (0, or this raises)."""
    torch.cuda.synchronize()
    if not torch.equal(rec.t, plain.t):
        raise AssertionError(f"{name}: t differs from the plain route")
    n_tied = tied(scene, form, rays, rec, plain)
    same = rec.idx == plain.idx
    err = 0.0
    for field in ("t", "hit", "pos", "ng", "ns", "u", "v", "mat", "kind",
                  "area"):
        got, want = getattr(rec, field), getattr(plain, field)
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            g, w = g[same], w[same]
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {field} differs where idx "
                                     "is equal")
            if g.numel():
                err = max(err, (g.double() - w.double()).abs().max().item())
    log(f"  {name}: rays={rec.t.shape[0]} "
        f"hit={rec.hit.float().mean().item():.4f} t bit-equal, idx differs "
        f"on {n_tied} exact t ties, every field bit-equal where idx is "
        f"(max abs error {err:.3g})")
    return err


def phase_intersect_scene(dev) -> dict:
    """Phase 23: ``intersect_scene`` on the card, through K1 (and K3 under
    the MT form) on simple_box's 1,048,576 primary rays and K5 on
    sphere_showcase's 262,144, each held to the plain route on the same
    rays and timed against ``intersect_core`` alone; then phase 4's
    render's counters."""
    log("== phase 23: intersect_scene (shade_hit of intersect_core) on the "
        "card")
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase
    from tuturenderer_tpu_torch.ops import intersect as TI
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    from tuturenderer_tpu_torch.scene.presets import simple_box
    from tuturenderer_tpu_torch.utils.profiling import rays_per_path
    from tuturenderer_tpu_torch.utils.timing import device_ms
    t_phase = time.perf_counter()
    errs = {}
    cases = (("simple_box 1024^2", lambda: simple_box(1024, 1024, device=dev),
              "woop", "nearest"),
             ("simple_box 1024^2, MT form", None, "mt", "mt_nearest"),
             ("sphere_showcase 512^2", lambda: sphere_showcase(
                 512, 512, device=dev), "woop", "cluster_nearest"))
    for name, make, form, key in cases:
        if make is not None:
            t0 = time.perf_counter()
            scene, cam = make()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            pix = torch.arange(cam.n_pixels, dtype=torch.int32, device=dev)
            o, d, _ = primary_ray(cam, pix % cam.width, pix // cam.width)
            rays = [c.contiguous() for c in (*o, *d)]
            log(f"  {name}: {scene.n_tris} triangles, {scene.n_spheres} "
                f"spheres, built in {build_s:.2f} s")
        with dense_kernel(form):
            for k in K.LAUNCHES:
                K.LAUNCHES[k] = 0
            rec = TI.intersect_scene(scene, o, d)
            torch.cuda.synchronize()
            check_launches(dict(K.LAUNCHES), {key: 1})
            with plain_route():
                plain = TI.intersect_scene(scene, o, d)
            errs[key] = hold_record(name, scene, form, rays, rec, plain)
            calls = {"intersect_scene": lambda: TI.intersect_scene(
                         scene, o, d),
                     "intersect_core": lambda: TI.intersect_core(
                         scene, o, d)}
            # a call launches a hundred kernels and more, and the launch
            # queue holds about a thousand behind the spin: 3 calls a
            # measurement, the median of 5
            ms = {k: float(np.median([device_ms(fn, reps=3, warm=1)
                                      for _ in range(5)]))
                  for k, fn in calls.items()}
            wall = {k: wall_ms(fn) for k, fn in calls.items()}
        share = 1.0 - ms["intersect_core"] / ms["intersect_scene"]
        log(f"  {name}: device ms intersect_scene={ms['intersect_scene']:.4f}"
            f" intersect_core={ms['intersect_core']:.4f} (shade_hit "
            f"{share * 100:.1f} % of intersect_scene); per call with launch "
            f"overhead intersect_scene={wall['intersect_scene']:.4f} "
            f"intersect_core={wall['intersect_core']:.4f}")
        del rec, plain
    # phase 4's render under utils/profiling.py's counters
    stats, opts, fracs = KEPT["simple_box stats"]
    bound = rays_per_path(opts.max_depth)
    if bound != 2.0 * (opts.max_depth + 1) + 0.1:
        raise AssertionError(f"rays_per_path({opts.max_depth}) = {bound}")
    if stats.paths != 1024 * 1024 * opts.spp or \
            stats.rays != stats.paths * bound:
        raise AssertionError(f"measure_render counted {stats.paths} paths, "
                             f"{stats.rays} rays")
    rpp = rays_per_path(opts.max_depth, list(fracs[:-1]),
                        epilogue=float(fracs[-1]))
    log(f"  measure_render of phase 4's render: {stats}; "
        f"rays_per_path({opts.max_depth}) = {bound:.4f} (all lanes alive), "
        f"{rpp:.4f} at the measured live fractions: "
        f"{stats.paths * rpp / stats.wall_s / 1e6:.2f} M rays/s")
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return errs


def phase_rng(dev, launches: int) -> dict:
    """Phase 24: the RNG kernel against the plain hash at the path
    tracer's widths; -> the kernel's entry for the kernels line, with
    ``launches``, those of phase 4's render."""
    log("== phase 24: the RNG kernel (csrc/rng.cu) against the plain hash")
    from tuturenderer_tpu_torch.utils import rng
    from tuturenderer_tpu_torch.utils.timing import device_ms
    t_phase = time.perf_counter()
    stats = {}
    err = 0.0
    for n in (1 << 20, 1 << 22):
        g = torch.Generator(device=dev).manual_seed(n)
        lane = torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        smp = torch.randint(0, 1 << 20, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        for purpose in range(12):
            before = rng.LAUNCHES
            got = rng.uniform(4100000001, lane, smp, 3, purpose)
            if rng.LAUNCHES != before + 1:
                raise AssertionError(f"a draw launched {rng.LAUNCHES - before}"
                                     " kernels, expected 1")
            want = rng.uniform_plain(4100000001, lane, smp, 3, purpose)
            err = max(err, float((got - want).abs().max()))
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                diff = int((got != want).sum())
                raise AssertionError(f"RNG kernel differs from the plain hash "
                                     f"on {diff} of {n} lanes, purpose "
                                     f"{purpose}")
        kernel = lambda: rng.uniform(4100000001, lane, smp, 3, rng.BSDF_U0)
        plain = lambda: rng.uniform_plain(4100000001, lane, smp, 3,
                                          rng.BSDF_U0)
        ms = device_ms(kernel)
        # the plain hash copies its Python-int words to the card and waits
        # at each copy, so its calls cannot be held behind a spin: its
        # time is a call's, host gaps included
        plain_ms = device_ms(plain, hold_ms=0)
        bound_ms = n * 12 / PEAK_BYTES * 1e3
        stats[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        wall_ms=wall_ms(kernel), plain_wall_ms=wall_ms(plain))
        log(f"  {n} lanes: 12 purposes bit-equal, one launch a draw; kernel "
            f"{ms:.4f} ms a draw (bound {bound_ms:.4f} ms by 12 bytes a "
            f"lane, {bound_ms / ms * 100:.1f} %), with launch overhead "
            f"{stats[n]['wall_ms']:.4f}; plain hash {plain_ms:.4f} ms a "
            f"draw, {stats[n]['plain_wall_ms']:.4f} a single call")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    main_n = 1 << 22
    return {"name": "rng_uniform", "route": "cuda",
            "source": "tuturenderer_tpu_torch/csrc/rng.cu",
            "replaces": None, "launches": launches, "max_abs_err": err,
            "ms": stats[main_n]["ms"], "plain_ms": stats[main_n]["plain_ms"],
            "bound_ms": stats[main_n]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "at_1M": {k: stats[1 << 20][k] for k in ("ms", "plain_ms",
                                                       "bound_ms")}}


# bytes a lane of each material type moves in each BSDF call: the columns
# csrc/bsdf.cu's branch of that type reads (4 bytes a float32 or int32
# column, 1 the TIR mask; a Python-float scene eta none) and its outputs
# (float32, and sample's two bools). Every lane reads its type; a lane of
# no admitted type reads nothing more. The Lambertian eval's diffuse is
# counted on rejected lanes too, which skip it.
BSDF_LANE_BYTES = {
    "eval": {"all": 4 + 12, "geometry": 48,
             0: 12, 1: 0, 2: 4 + 1, 3: 12 + 4 + 4, 4: 4 + 4 + 1, 5: None},
    "sample": {"all": 4 + 12 + 12 + 4 + 4 + 12 + 2, "geometry": 0,
               0: 0, 1: 0, 2: 4 + 4, 3: 4, 4: 4 + 4 + 4, 5: 0},
    "pdf": {"all": 4 + 4, "geometry": 36,
            0: 0, 1: 0, 2: 4, 3: 4, 4: 4 + 4, 5: None},
}


def bsdf_inputs(dev, n: int, seed: int):
    """(params, wi, wo, ng, ns, tir, (r0, r1, lottery)) of ``n`` lanes on
    ``dev``, every material type equally often, a fifth of the wi the
    mirror of wo (the delta branches fire), a fifth of the lanes TIR."""
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.utils.vec import Vec3, reflect
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda: torch.rand(n, generator=g, device=dev)

    def unit():
        v = torch.randn(3, n, generator=g, device=dev)
        return Vec3(*(v / v.norm(dim=0)))
    p = TM.MatParams(
        mtype=torch.randint(0, 6, (n,), generator=g, device=dev,
                            dtype=torch.int32),
        diffuse=Vec3(r(), r(), r()), specular=Vec3(r(), r(), r()),
        emission=Vec3(r(), r(), r()), alpha=r(), eta=1.1 + r(),
        roughness=0.05 + 0.95 * r(), metallic=r())
    ns = unit()
    ng = (ns + unit() * 0.3).normalized(1e-20)
    wo, wi = unit(), unit()
    mirror = torch.arange(n, device=dev) % 5 == 0
    wi = Vec3(*(torch.where(mirror, a, b) for a, b in
                zip(reflect(wo, ns).normalized(1e-20), wi)))
    return p, wi, wo, ng, ns, r() < 0.2, (r(), r(), r())


def bsdf_bytes_of(out) -> torch.Tensor:
    """A BSDF call's outputs (a tensor, a Vec3, a SampleResult) as one
    column of their bytes: equal bytes are equal bits, NaNs included."""
    return torch.cat([c.reshape(-1).view(torch.uint8)
                      for c in torch.utils._pytree.tree_leaves(out)])


def bsdf_bytes(call: str, mtype: torch.Tensor) -> int:
    """The bytes of ``BSDF_LANE_BYTES`` over the lanes of ``mtype``."""
    table = BSDF_LANE_BYTES[call]
    counts = torch.bincount(mtype.long(), minlength=6).tolist()
    total = table["all"] * mtype.numel()
    for t, k in enumerate(counts[:6]):
        if table[t] is not None:
            total += k * (table["geometry"] + table[t])
    return total


def phase_bsdf(dev, launches: dict) -> list:
    """Phase 25: the BSDF kernels against the plain versions at the path
    tracer's widths; -> their entries for the kernels line, each with
    phase 4's launches."""
    log("== phase 25: the BSDF kernels (csrc/bsdf.cu) against the plain "
        "versions")
    from tuturenderer_tpu_torch import materials as TM
    from tuturenderer_tpu_torch.utils.timing import device_ms
    t_phase = time.perf_counter()
    stats = {}
    for n in (1 << 20, 1 << 22):
        p, wi, wo, ng, ns, tir, (r0, r1, lot) = bsdf_inputs(dev, n, n)
        eta = torch.tensor(1.0, device=dev)
        calls = {
            "eval": [(lambda f, a=a, t=t: f(p, wi, wo, ng, ns, eta, a, t))
                     for a in (False, True) for t in (None, tir)],
            "sample": [(lambda f, b=b: f(p, wo, ns, r0, r1, lot, eta, b))
                       for b in (False, True)],
            "pdf": [(lambda f: f(p, wi, wo, ns, eta, p.eta))]}
        for call, variants in calls.items():
            kernel = getattr(TM, f"bxdf_{call}")
            plain = getattr(TM, f"bxdf_{call}_plain")
            for v in variants:
                before = TM.LAUNCHES[call]
                got, want = v(kernel), v(plain)
                if TM.LAUNCHES[call] != before + 1:
                    raise AssertionError(f"bxdf_{call} launched "
                                         f"{TM.LAUNCHES[call] - before}")
                if not torch.equal(bsdf_bytes_of(got), bsdf_bytes_of(want)):
                    raise AssertionError(f"bxdf_{call} kernel differs from "
                                         f"the plain version at {n} lanes")
            ms = device_ms(lambda: variants[0](kernel))
            plain_ms = device_ms(lambda: variants[0](plain), hold_ms=0)
            bound_ms = bsdf_bytes(call, p.mtype) / PEAK_BYTES * 1e3
            stats[(call, n)] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms)
            log(f"  {n} lanes, {call}: {len(variants)} variants bit-equal, "
                f"one launch a call; kernel {ms:.4f} ms (bound "
                f"{bound_ms:.4f} ms by bytes, {bound_ms / ms * 100:.1f} %); "
                f"plain {plain_ms:.3f} ms")
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    big, small = 1 << 22, 1 << 20
    return [{"name": f"bsdf_{call}", "route": "cuda",
             "source": "tuturenderer_tpu_torch/csrc/bsdf.cu",
             "replaces": None, "launches": launches[f"bsdf_{call}"],
             "max_abs_err": 0.0, **stats[(call, big)], "bound_by": "bytes",
             "library_ms": None,
             "at_1M": stats[(call, small)]} for call in ("eval", "sample",
                                                         "pdf")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs, times, bounds = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_reference(dev)
    cl_errs, cl_stats = phase_cluster_kernels(dev)
    runs = phase_mesh_slice(dev)
    phase_mesh_references(dev)
    train = phase_train_dense(dev)
    phase_train_mesh(dev)
    phase_training_steps(dev)
    phase_grad_references(dev)
    visit_launches, visit_err, visit = phase_visit(dev)
    t_new = time.perf_counter()
    # phases 14-16 hold each kernel to its plain version on the inputs of
    # the new paths too: their errors join the kernels line's
    for new_errs in (phase_golden(dev), phase_compaction(dev),
                     phase_light_naive(dev)):
        merge_errs(errs, {k: v for k, v in new_errs.items() if k in errs})
        merge_errs(cl_errs, {k: v for k, v in new_errs.items()
                             if k not in errs})
    t_bdpt = time.perf_counter()
    log(f"phases 14-16: {t_bdpt - t_new:.1f} s")
    # phases 17-20: BDPT and the light tracer's and BDPT's gradients; K1/K2
    # and K5/K6 held to their plain versions on BDPT's inputs too
    new_errs = phase_bdpt(dev)
    merge_errs(errs, {k: v for k, v in new_errs.items() if k in errs})
    merge_errs(cl_errs, {k: v for k, v in new_errs.items() if k not in errs})
    phase_bdpt_golden(dev)
    phase_bdpt_references(dev)
    merge_errs(errs, phase_bdpt_train(dev))
    t_shell = time.perf_counter()
    log(f"phases 17-20: {t_shell - t_bdpt:.1f} s")
    # phases 21-22: the shell and the sharded entry points; K1/K2 and K5/K6
    # held to their plain versions on a sharded render's inputs too
    phase_cli(dev)
    t_shard = time.perf_counter()
    new_errs = phase_sharded(dev)
    merge_errs(errs, {k: v for k, v in new_errs.items() if k in errs})
    merge_errs(cl_errs, {k: v for k, v in new_errs.items() if k not in errs})
    log(f"phase 21: {t_shard - t_shell:.1f} s; phase 22: "
        f"{time.perf_counter() - t_shard:.1f} s")
    # phase 23: intersect_scene through K1, K3 and K5, held to the plain
    # route on the same rays
    new_errs = phase_intersect_scene(dev)
    merge_errs(errs, {k: v for k, v in new_errs.items() if k in errs})
    merge_errs(cl_errs, {k: v for k, v in new_errs.items() if k not in errs})
    rng_kernel = phase_rng(dev, launches["rng_uniform"])
    bsdf_kernels = phase_bsdf(dev, launches)
    log(f"the whole script: {time.perf_counter() - t_start:.1f} s")
    # K1/K2 launches from the simple_box render, K3/K4 from the dense
    # training path's forward+backward; times and bounds at simple_box's
    # 1,048,576 rays
    launches.update({k: train[k] for k in ("mt_nearest", "mt_anyhit")})
    kernels = [{
        "name": KERNEL_NAMES[k], "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k], "launches": launches[k],
        "max_abs_err": errs[k], "ms": times[k],
        "plain_ms": times[k + "_plain"],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": None,
    } for k in ("nearest", "anyhit", "mt_nearest", "mt_anyhit")]
    # launches from the render of each kernel's path: K5/K6 the
    # sphere_showcase render, K7 the translucent alpha render
    path_of = {"cluster_nearest": "sphere_showcase",
               "cluster_anyhit": "sphere_showcase",
               "cluster_transmit": "translucent"}
    kernels += [{
        "name": KERNEL_NAMES[k], "route": "cuda", "source": SOURCES[k],
        "replaces": REPLACES[k], "launches": runs[path_of[k]][k],
        "max_abs_err": cl_errs[k], "ms": cl_stats[k]["ms"],
        "plain_ms": cl_stats[k]["plain_ms"],
        "bound_ms": cl_stats[k]["bound_ms"],
        "bound_by": cl_stats[k]["bound_by"], "library_ms": None,
    } for k in ("cluster_nearest", "cluster_anyhit", "cluster_transmit")]
    kernels.append({
        "name": KERNEL_NAMES["proto_visit"], "route": "cuda",
        "source": SOURCES["proto_visit"], "replaces": REPLACES["proto_visit"],
        "launches": visit_launches["proto_visit"], "max_abs_err": visit_err,
        **visit, "library_ms": None})
    kernels.append(rng_kernel)
    kernels += bsdf_kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
