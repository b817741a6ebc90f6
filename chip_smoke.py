#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and nvcc.
Phases, in order; any failure raises and the script exits non-zero:

1. device: name, power limit, torch and CUDA versions;
2. build: nvcc compiles ``tuturenderer_tpu_torch/csrc/dense_intersect.cu``;
3. each dense intersection kernel against its plain PyTorch version on the
   card: simple_box's 12 triangles at 1,048,576 rays, a 4095-triangle soup
   at 65,536 rays, rays aimed at shared edges and vertices, and shadow
   distances at 0.5x, 1x, 2x and within 1e-4 of the hit distance; with the
   device time of each, from the profiler's CUDA trace;
4. the slice: ``render(simple_box(1024, 1024), RenderOptions(spp=64))`` on
   the card, with the kernel launch counts of that run;
5. the render at the size of the stored JAX reference image
   (``tests/data/torch_simple_box_jax_ref.npy``) against that image.

The line before the last is a JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits with code 1 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REF_IMAGE = "tests/data/torch_simple_box_jax_ref.npy"
REF_SIZE, REF_SPP, REF_SEED = (24, 20), 4, 3   # how the reference was made
SOURCE = "tuturenderer_tpu_torch/csrc/dense_intersect.cu"
REPLACES = {"nearest": "tuturenderer_tpu/ops/pallas/intersect.py:164",
            "anyhit": "tuturenderer_tpu/ops/pallas/intersect.py:218"}
KERNEL_NAMES = {"nearest": "woop_nearest", "anyhit": "woop_anyhit"}


def log(msg: str):
    print(msg, flush=True)


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one call: the device time of every kernel the
    call launches, from the profiler's CUDA trace (host overhead left out;
    the kernels are far shorter than a launch from Python)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / reps / 1e3


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


def compare_kernels(name: str, table, o, d, report: dict):
    """Kernel vs plain on one ray set, nearest hit and any hit; returns the
    kernel and plain median times (ms)."""
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    rays = cols(o) + cols(d)
    tk, ik, uk, vk = K.tri_intersect(table, *rays)
    tp, ip, up, vp = K.tri_intersect_plain(table, *rays)
    torch.cuda.synchronize()
    hk, hp = ik >= 0, ip >= 0
    agree = (hk == hp).float().mean().item()
    both = hk & hp
    t_err = (tk - tp)[both].abs().max().item() if both.any() else 0.0
    # the kernel and the plain version both keep the lowest index on an
    # exact t tie, so every idx must agree; a differing idx would have to
    # be a tie
    idx_diff = both & (ik != ip)
    same = both & (ik == ip)
    uv_err = max((uk - up)[same].abs().max().item(),
                 (vk - vp)[same].abs().max().item()) if same.any() else 0.0
    log(f"  {name}: nearest rays={o.shape[0]} hit={hp.float().mean().item():.4f}"
        f" hit/miss agreement={agree:.6f} max|dt|={t_err:.3g}"
        f" idx differs={int(idx_diff.sum())} max|du|,|dv|={uv_err:.3g}")
    if agree != 1.0:
        raise AssertionError(f"{name}: hit/miss disagree on "
                             f"{(1 - agree) * 100:.4f}% of rays")
    if both.any():
        torch.testing.assert_close(tk[both], tp[both], rtol=1e-5, atol=0.0)
    if bool((tk[idx_diff] != tp[idx_diff]).any()):
        raise AssertionError(f"{name}: idx differs where t is unique")
    if uv_err > 1e-5:
        raise AssertionError(f"{name}: barycentrics differ by {uv_err}")
    err = max(t_err, uv_err)
    report["nearest"] = max(report.get("nearest", 0.0), err)

    # shadow rays: dist at 0.5x, 1x, 2x and within 1e-4 of the hit
    t_ref = torch.where(hp, tp, torch.full_like(tp, 10.0))
    any_err = 0.0
    for f, off in ((0.5, 0.0), (1.0, 0.0), (2.0, 0.0), (1.0, 5e-5),
                   (1.0, -5e-5), (1.0, 2e-4), (1.0, -2e-4)):
        dist = (t_ref * f + off).contiguous()
        bk = K.tri_occluded(table, *rays, dist)
        bp = K.tri_occluded_plain(table, *rays, dist)
        n_diff = int((bk != bp).sum())
        any_err = max(any_err, float(n_diff > 0))
        log(f"  {name}: any-hit dist=t*{f}{off:+g} blocked="
            f"{bp.float().mean().item():.4f} disagree={n_diff}")
        if n_diff:
            raise AssertionError(f"{name}: any-hit disagrees on {n_diff} rays")
    report["anyhit"] = max(report.get("anyhit", 0.0), any_err)

    dist = (t_ref * 2.0).contiguous()
    calls = {"nearest": lambda: K.tri_intersect(table, *rays),
             "nearest_plain": lambda: K.tri_intersect_plain(table, *rays),
             "anyhit": lambda: K.tri_occluded(table, *rays, dist),
             "anyhit_plain": lambda: K.tri_occluded_plain(table, *rays, dist)}
    ms = {k: device_ms(fn) for k, fn in calls.items()}
    wall = {k: wall_ms(fn) for k, fn in calls.items()}
    for k in ("nearest", "anyhit"):
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
    t0 = time.perf_counter()
    build.load("dense_intersect")
    secs = time.perf_counter() - t0
    if "dense_intersect" in build.BUILD_LOG:
        nvcc_s, out = build.BUILD_LOG["dense_intersect"]
        log(f"nvcc {' '.join(build.NVCC_FLAGS)}: built in {nvcc_s:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {line.strip()}")
    else:
        log(f"library already built: {build.library_path('dense_intersect')}")
    log(f"load: {secs:.2f} s")


def phase_kernels(dev):
    log("== phase 3: kernels vs plain on the card")
    from tuturenderer_tpu_torch.ops.cuda.intersect import pack_triangles_woop
    from tuturenderer_tpu_torch.scene.data import SceneBuilder
    from tuturenderer_tpu_torch.scene.presets import simple_box
    gen = torch.Generator(device=dev).manual_seed(0)
    report, times = {}, {}

    # simple_box: 2^19 camera rays (a checkerboard of the 1024^2 frame) and
    # 2^19 bounce rays from random points inside the box
    scene, cam = simple_box(1024, 1024, device=dev)
    table = pack_triangles_woop(scene)
    from tuturenderer_tpu_torch.camera import primary_ray
    ys, xs = torch.meshgrid(torch.arange(1024, device=dev),
                            torch.arange(1024, device=dev), indexing="ij")
    keep = ((xs + ys) % 2 == 0).reshape(-1)
    px, py = xs.reshape(-1)[keep], ys.reshape(-1)[keep]
    o_cam, d_cam, _ = primary_ray(cam, px, py)
    half = px.shape[0]
    o_b = torch.rand((half, 3), generator=gen, device=dev) * 1.98 - 0.99
    d_b = random_unit(half, gen, dev)
    o = torch.cat([torch.stack(list(o_cam), 1), o_b])
    d = torch.cat([torch.stack(list(d_cam), 1), d_b])
    assert o.shape[0] == 1 << 20
    times["simple_box"] = compare_kernels("simple_box 12 tris", table, o, d,
                                          report)

    # rays at shared edges and vertices
    eye = torch.stack(list(cam.position)).to(dev)
    oe, de = edge_rays(scene, eye, dev)
    compare_kernels("simple_box edges+vertices", table, oe, de, report)

    # a 4095-triangle soup, 65,536 rays
    r = np.random.RandomState(7)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(4095, 3) * 2.0
    b.add_triangles((centers[:, None, :] + 0.6 * r.randn(4095, 3, 3))
                    .astype(np.float32), None, None, m)
    soup = b.build(device=dev)
    o = torch.randn((65536, 3), generator=gen, device=dev) * 3.0
    d = random_unit(65536, gen, dev)
    times["soup"] = compare_kernels("soup 4095 tris", pack_triangles_woop(soup),
                                    o, d, report)
    return report, times


def phase_slice(dev):
    log("== phase 4: render(simple_box(1024, 1024), RenderOptions(spp=64))")
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.integrators.path import render, trace_rays
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    opts = RenderOptions(spp=64)
    scene, cam = simple_box(1024, 1024, device=dev)
    # warm-up at a small size (allocator, lazy module loads); not counted
    s_small, c_small = simple_box(64, 64, device=dev)
    render(s_small, c_small, RenderOptions(spp=1), seed=0)
    torch.cuda.synchronize()

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img = render(scene, cam, opts, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)

    per_sample = {"nearest": opts.max_depth + 2, "anyhit": opts.max_depth + 1}
    log(f"launches: {launches} (straight port expects "
        f"{ {k: v * opts.spp for k, v in per_sample.items()} })")
    for k, v in per_sample.items():
        if launches[k] != v * opts.spp:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{v * opts.spp}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render produced non-finite pixels")
    if tuple(img.shape) != (1024, 1024, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")

    # live-lane fractions per bounce from one sample at every 4th pixel:
    # 2 rays (intersection + shadow) per live lane and bounce, 1 for the
    # epilogue's pending lanes (the accounting of bench.py)
    lane = torch.arange(0, cam.n_pixels, 4, dtype=torch.int32, device=dev)
    o, d, _ = primary_ray(cam, lane % cam.width, lane // cam.width)
    _, counts = trace_rays(scene, cam, o, d, lane, 0, 0, opts,
                           collect_alive=True)
    fracs = counts.double().cpu().numpy() / lane.shape[0]
    rays_per_path = 2.0 * fracs[:-1].sum() + fracs[-1]
    primary = cam.n_pixels * opts.spp
    mean = img.mean().item()
    log(f"render: wall={wall:.3f} s  image mean={mean:.6f}  "
        f"primary rays/s={primary / wall / 1e6:.2f} M  "
        f"total rays/s={primary * rays_per_path / wall / 1e6:.2f} M  "
        f"(rays/path={rays_per_path:.4f}, live fractions="
        f"{np.round(fracs, 4).tolist()})")
    return launches


def phase_reference(dev):
    log("== phase 5: against the stored JAX reference image")
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.options import RenderOptions
    from tuturenderer_tpu_torch.scene.presets import simple_box
    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               REF_IMAGE))
    w, h = REF_SIZE
    scene, cam = simple_box(w, h, device=dev)
    img = render(scene, cam, RenderOptions(spp=REF_SPP), seed=REF_SEED)
    img = img.cpu().numpy()
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    rel_mean = abs(img.mean() - ref.mean()) / ref.mean()
    log(f"pixels within rtol 1e-4 / atol 1e-5: {close.mean() * 100:.2f}% "
        f"(CPU test bar 99%), image mean {img.mean():.6f} vs "
        f"{ref.mean():.6f} (rel {rel_mean:.2e}, bar 0.5%); no widening")
    if close.mean() < 0.99 or rel_mean > 0.005:
        raise AssertionError("render disagrees with the JAX reference")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_device()
    phase_build()
    errs, times = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_reference(dev)
    kernels = [{
        "name": KERNEL_NAMES[k], "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[k], "launches": launches[k],
        "max_abs_err": errs[k], "ms": times["simple_box"][k],
        "plain_ms": times["simple_box"][k + "_plain"],
    } for k in ("nearest", "anyhit")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
