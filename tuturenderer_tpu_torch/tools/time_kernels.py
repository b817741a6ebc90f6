"""Device time of every intersection kernel (K1-K8) at the main path's
shapes, in whichever checkout of the port is first on the import path.

    PYTHONPATH=<checkout> python3 tuturenderer_tpu_torch/tools/time_kernels.py \
        [--label NAME] [--out FILE] [--only dense|cluster|visit] [--sass DIR]

It needs a CUDA device and nvcc; the kernels build from ``<checkout>``'s
sources. It calls only the kernels' public wrappers, the scene presets,
``tools/proto_visit.py``'s ``scenario``, ``tensors``, ``walk_plain`` and
``_launch`` and ``utils/timing.py``, whose signatures older checkouts
share, so it times an older checkout (the parent of a change, unpacked by
``git archive`` into a directory that ``.gitignore`` lists) as well as
this one. Comparing two versions of a kernel is then one command on the
card, the two checkouts in turns, each in its own process:

    for t in <old> <new> <new> <old>; do
        PYTHONPATH=$t python3 tuturenderer_tpu_torch/tools/time_kernels.py \
            --label $t; done

The shapes are ``chip_smoke.py``'s (which takes them from here): the dense
kernels at simple_box's 1,048,576 rays (12 triangles) and the
4095-triangle soup at 65,536 rays, in both forms (Woop K1/K2,
Moller-Trumbore K3/K4, the any hits at twice the hit distance); the
cluster kernels at the 262,144-ray bounce wavefronts of
sphere_showcase(512, 512) and terrain(512, 512, nx=724, nz=724), K7 on
the table whose alphas are drawn from {0.3, 0.85, 1.0}; the visit-walk
probe K8 in its "full" and "early" scenarios at 64 tiles x 1024 clusters.
Each time is ``utils/timing.py``'s ``device_ms``, read twice in turns
over the kernels; beside it, a checksum of the outputs (the sum of t over
hits, the count of blocked rays, the sum of the transmittances; for K8
the sum of t over hits and the count of idx >= 0), equal across
checkouts when the kernels compute the same. For the dense kernels and
K8 it also gives the tests the data needs (every ray/triangle pair for a
nearest hit; for an any hit, each ray's tests up to its first blocker;
for K8 the plane tests of the valid clusters of the groups each tile
walks) and the warp-instruction slots per test that the time takes at
the SM clock nvidia-smi reads under load (4 schedulers per SM, 32 tests
per slot), and for K8 the SMs its launch occupies where the checkout can
report them (``proto_visit.sm_ids``). It prints nvcc's register and spill
lines for the libraries it built, and per kernel the instructions,
``FCHK`` (the IEEE division's range check) and ``CALL`` (to its slow
path) in ``cuobjdump -sass``; ``--sass DIR`` writes the whole listing
there. ``--only`` times one family (``--dense-only`` is ``--only
dense``). The last line is one JSON object, also written to ``--out``.

``capture`` copies the inputs of chosen kernel calls of a render (the
bounce wavefronts here; the new paths' inputs in ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess

import numpy as np
import torch


def _cols(a):
    return [a[:, i].contiguous() for i in range(3)]


def _unit(n, gen, dev):
    d = torch.randn((n, 3), generator=gen, device=dev)
    return d / d.norm(dim=1, keepdim=True)


def dense_sets(dev):
    """{name: (scene, camera or None, six ray columns)}: simple_box's 1M
    rays (a checkerboard of the 1024^2 frame's camera rays and as many
    bounce rays from random points inside the box) and a 4095-triangle
    soup at 65,536 rays, from fixed seeds."""
    from tuturenderer_tpu_torch.camera import primary_ray
    from tuturenderer_tpu_torch.scene.presets import simple_box
    gen = torch.Generator(device=dev).manual_seed(0)
    scene, cam = simple_box(1024, 1024, device=dev)
    ys, xs = torch.meshgrid(torch.arange(1024, device=dev),
                            torch.arange(1024, device=dev), indexing="ij")
    keep = ((xs + ys) % 2 == 0).reshape(-1)
    px, py = xs.reshape(-1)[keep], ys.reshape(-1)[keep]
    o_cam, d_cam, _ = primary_ray(cam, px, py)
    half = px.shape[0]
    o_b = torch.rand((half, 3), generator=gen, device=dev) * 1.98 - 0.99
    d_b = _unit(half, gen, dev)
    o = torch.cat([torch.stack(list(o_cam), 1), o_b])
    d = torch.cat([torch.stack(list(d_cam), 1), d_b])
    o_s = torch.randn((65536, 3), generator=gen, device=dev) * 3.0
    d_s = _unit(65536, gen, dev)
    return {"simple_box 1M": (scene, cam, _cols(o) + _cols(d)),
            "soup 4095 x 65536": (soup(4095, dev), None,
                                  _cols(o_s) + _cols(d_s))}


def soup(n_tris: int, dev, seed: int = 7):
    """A scene of ``n_tris`` random triangles: centres drawn from
    N(0, 2^2) per axis, corners 0.6 N(0, 1) around them, from numpy's
    ``RandomState(seed)``."""
    from tuturenderer_tpu_torch.scene.data import SceneBuilder
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    b.add_triangles((centers[:, None, :] + 0.6 * r.randn(n_tris, 3, 3))
                    .astype(np.float32), None, None, m)
    return b.build(device=dev)


def anyhit_tests(tile, floats: int, table, rays, dist,
                 chunk: int = 8192) -> int:
    """The ray/triangle tests a serial any hit makes: per ray, up to and
    including its first blocker in index order, or every triangle.
    ``tile`` is a plain per-triangle test (``_woop_tile``, ``_mt_tile``)."""
    from tuturenderer_tpu_torch.ops.cuda.intersect import PARALLEL_EPS
    tri = table.reshape(-1, floats)
    total = 0
    for lo in range(0, rays[0].shape[0], chunk):
        t, _, _, ok = tile(tri, *[c[lo:lo + chunk, None] for c in rays])
        d = dist[lo:lo + chunk, None]
        ok = ok & (t < d) & ((t - d).abs() >= PARALLEL_EPS)
        first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1) + 1,
                            tri.shape[0])
        total += int(first.sum())
    return total


def dense_calls(dev) -> dict:
    """{(kernel, shape): (call, checksum, ray/triangle tests)} of K1-K4,
    the any hits at twice the hit distance."""
    from tuturenderer_tpu_torch.ops.cuda import intersect as K
    forms = (("K1", "K2", K.pack_triangles_woop, K.tri_intersect,
              K.tri_occluded, K._woop_tile, 13),
             ("K3", "K4", K.pack_triangles, K.tri_intersect_mt,
              K.tri_occluded_mt, K._mt_tile, 12))
    calls = {}
    for shape, (scene, _, rays) in dense_sets(dev).items():
        for k_near, k_occ, pack, near, occ, tile, floats in forms:
            table = pack(scene)
            t, idx, _, _ = near(table, *rays)
            dist = torch.where(idx >= 0, t, torch.full_like(t, 10.0)) * 2.0
            calls[(k_near, shape)] = (
                lambda n=near, tb=table, r=rays: n(tb, *r),
                lambda out: float(out[0][out[1] >= 0].double().sum()),
                rays[0].shape[0] * (table.shape[0] // floats))
            calls[(k_occ, shape)] = (
                lambda o=occ, tb=table, r=rays, dd=dist: o(tb, *r, dd),
                lambda out: float(out.sum()),
                anyhit_tests(tile, floats, table, rays, dist))
    return calls


def at(i: int):
    """A capture pick: the call of index ``i``."""
    return lambda seen: len(seen) == i + 1


def first_shrunk(seen) -> bool:
    """A capture pick: the first call narrower than the first, one
    compacted width."""
    return seen[-1] < seen[0] and min(seen[:-1]) == seen[0]


@contextlib.contextmanager
def capture(**picks):
    """Copy the inputs of chosen kernel calls of a render. Each keyword
    names a kernel wrapper that ops/intersect.py calls (tri_intersect,
    tri_occluded, cluster_intersect, cluster_occluded,
    cluster_transmittance) and maps it to {label: pick}; a pick takes the
    lane counts of that wrapper's calls so far, this one last. The yielded
    dict gets, for each label, the (table, ray columns [+ dist]) of the
    call its pick took; a label no call matched raises on exit. The calls
    still go to the kernels and are counted as ever. BDPT's wavefronts run
    eagerly inside, so that every one makes its calls (no graph replays)."""
    from tuturenderer_tpu_torch.integrators import bdpt
    from tuturenderer_tpu_torch.ops import intersect as I
    got = {name: {} for name in picks}
    orig = {name: getattr(I, name) for name in picks}

    def wrap(name):
        seen = []

        def call(table, *cols, **kw):
            seen.append(cols[0].shape[0])
            for label, pick in picks[name].items():
                if label not in got[name] and pick(seen):
                    got[name][label] = (table, [c.clone() for c in cols])
            return orig[name](table, *cols, **kw)
        return call

    for name in picks:
        setattr(I, name, wrap(name))
    graphs, bdpt.GRAPHS = bdpt.GRAPHS, False
    try:
        yield got
    finally:
        bdpt.GRAPHS = graphs
        for name, fn in orig.items():
            setattr(I, name, fn)
    missed = [(n, label) for n, want in picks.items() for label in want
              if label not in got[n]]
    if missed:
        raise RuntimeError(f"no call matched {missed}")


def wavefront(scene, cam):
    """The inputs of the depth-1 nearest-hit and shadow calls of a 1-spp
    render: a bounce wavefront as the main path gives it to the kernels
    (dead lanes included, masked as the path masks them)."""
    from tuturenderer_tpu_torch.integrators.path import render
    from tuturenderer_tpu_torch.options import RenderOptions
    with capture(cluster_intersect={"depth 1": at(1)},
                 cluster_occluded={"depth 1": at(1)}) as got:
        render(scene, cam, RenderOptions(spp=1), seed=0)
    return got["cluster_intersect"]["depth 1"][1], \
        got["cluster_occluded"]["depth 1"][1]


def alpha_table(clusters, dev):
    """The clusters with every real row's alpha (slot 13) drawn from
    {0.3, 0.85, 1.0}."""
    woop = clusters.woop.clone()
    rows = woop.view(woop.shape[0], -1)[:, :64 * 14].view(-1, 64, 14)
    gen = torch.Generator(device=dev).manual_seed(4)
    pick = torch.randint(0, 3, rows.shape[:2], generator=gen, device=dev)
    rows[..., 13] = torch.tensor([0.3, 0.85, 1.0], device=dev)[pick]
    return dataclasses.replace(clusters, woop=woop)


def cluster_calls(dev) -> dict:
    """{(kernel, shape): (call, checksum)} of K5-K7 at both wavefronts."""
    from tuturenderer_tpu_torch.models.scenes import sphere_showcase, terrain
    from tuturenderer_tpu_torch.ops.cuda import cluster as C
    calls = {}
    for shape, make in (
            ("showcase wavefront", lambda: sphere_showcase(512, 512,
                                                           device=dev)),
            ("terrain wavefront", lambda: terrain(512, 512, nx=724, nz=724,
                                                  device=dev))):
        scene, cam = make()
        cl = scene.clusters
        alpha_cl = alpha_table(cl, dev)
        near, occ = wavefront(scene, cam)
        calls[("K5", shape)] = (
            lambda c=cl, r=near: C.cluster_intersect(c, *r),
            lambda out: float(out[0][out[1] >= 0].double().sum()), None)
        calls[("K6", shape)] = (
            lambda c=cl, r=occ: C.cluster_occluded(c, *r),
            lambda out: float(out.sum()), None)
        calls[("K7", shape)] = (
            lambda c=alpha_cl, r=occ: C.cluster_transmittance(c, *r),
            lambda out: float(out.double().sum()), None)
    return calls


VISIT_SHAPE = (1024, 64)    # K8: clusters in a visit list, tiles


def visit_tests(ventry, groups, nc: int) -> int:
    """K8's plane tests that the data needs: per tile, 64 planes of each
    valid cluster (entry below the sentinel) of the groups it walks, for
    each of its 1024 rays."""
    from tuturenderer_tpu_torch.tools import proto_visit as P
    ve = ventry.reshape(-1, nc)
    total = 0
    for tile, g in enumerate(groups.tolist()):
        total += int((ve[tile, :g * P.G] < P.SENTINEL).sum())
    return total * P.CS * P.TILE


def visit_checksum(out) -> list:
    """[sum of t over hits, count of idx >= 0] of a K8 result."""
    t, idx = out
    hit = idx >= 0
    return [float(t[hit].double().sum()), int(hit.sum())]


def visit_calls(dev, nc: int = VISIT_SHAPE[0],
                n_tiles: int = VISIT_SHAPE[1]) -> dict:
    """{("K8", scenario): (call, checksum, plane tests)} of the visit-walk
    probe's launch alone (``_launch``: ``run`` reads its visit lists on
    the host and so synchronises) in its "full" and "early" scenarios,
    and the inputs of each under "args"."""
    from tuturenderer_tpu_torch.tools import proto_visit as P
    calls = {}
    for name in ("full", "early"):
        args = P.tensors(P.scenario(name, nc, n_tiles), dev)
        _, _, groups = P.walk_plain(*args, nc=nc)
        calls[("K8", f"{name} {n_tiles} x {nc}")] = (
            lambda a=args: P._launch(a[0], a[1], a[2:9], a[9], nc, n_tiles),
            visit_checksum, visit_tests(args[1], groups, nc), args)
    return calls


def visit_sms(args, nc: int = VISIT_SHAPE[0],
              n_tiles: int = VISIT_SHAPE[1]):
    """The SMs one K8 launch occupies, or None where the checkout's probe
    cannot report them."""
    from tuturenderer_tpu_torch.tools import proto_visit as P
    if not hasattr(P, "sm_ids"):
        return None
    ids = P.sm_ids(args[0], args[1], args[2:9], args[9], nc, n_tiles)
    return int(torch.unique(ids).numel())


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def sm_clock_mhz(fn, reads: int = 5, burst: int = 300) -> float:
    """The median SM clock nvidia-smi reads while the card runs ``fn``:
    each read is taken with ``burst`` calls queued behind it."""
    mhz = []
    for _ in range(reads):
        for _ in range(burst):
            fn()
        mhz.append(float(_smi("clocks.sm").split()[0]))
        torch.cuda.synchronize()
    return float(np.median(mhz))


def ptxas_lines(name: str) -> list:
    """The register and spill lines nvcc printed for ``csrc/<name>.cu``,
    where this process built it."""
    from tuturenderer_tpu_torch.ops.cuda import build
    if name not in build.BUILD_LOG:
        return []
    return [line.strip() for line in build.BUILD_LOG[name][1].splitlines()
            if "registers" in line or "spill" in line or
            "Compiling" in line]


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the library built from ``csrc/<name>.cu``."""
    from tuturenderer_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_counts(listing: str) -> dict:
    """{kernel: (instructions, FCHK, CALL)} of a ``cuobjdump -sass``
    listing: each kernel's instruction lines (``/*0a70*/`` addresses), its
    division range checks and its calls (the division's slow path)."""
    counts, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0]
        elif name and line.strip().startswith("/*") and "*/" in line:
            op = line.split("*/", 1)[1].strip()
            if not op or op.startswith("/*"):
                continue
            counts[name][0] += 1
            counts[name][1] += "FCHK" in op
            counts[name][2] += "CALL" in op
    return {k: tuple(v) for k, v in counts.items()}


FAMILIES = {"dense": "dense_intersect", "cluster": "bvh_walk",
            "visit": "proto_visit"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="", help="names the checkout")
    p.add_argument("--out", default="", help="also write the JSON here")
    p.add_argument("--only", choices=sorted(FAMILIES),
                   help="time one family of kernels")
    p.add_argument("--dense-only", dest="only", action="store_const",
                   const="dense", help="the same as --only dense")
    p.add_argument("--sass", default="",
                   help="write each library's cuobjdump -sass here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    from tuturenderer_tpu_torch.ops.cuda import build
    from tuturenderer_tpu_torch.utils.timing import device_ms
    import tuturenderer_tpu_torch
    dev = torch.device("cuda", 0)
    smi = _smi("name,power.limit")
    root = os.path.dirname(os.path.dirname(tuturenderer_tpu_torch.__file__))
    print(f"time_kernels {args.label}: the port at {root}; {smi}",
          flush=True)
    families = [args.only] if args.only else list(FAMILIES)
    libs = [FAMILIES[f] for f in families]
    build.load_all(libs)
    for name in libs:
        for line in ptxas_lines(name):
            print(f"  {name}.cu: {line}", flush=True)
        listing = sass(name)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, f"{name}.sass"), "w") as f:
                f.write(listing)
        for kernel, (n, fchk, call) in sass_counts(listing).items():
            print(f"  {name}.cu SASS {kernel}: {n} instructions, {fchk} "
                  f"FCHK, {call} CALL", flush=True)
    calls = {}
    if "dense" in families:
        calls.update(dense_calls(dev))
    if "cluster" in families:
        calls.update(cluster_calls(dev))
    visit_args = {}
    if "visit" in families:
        for key, (call, check, tests, a) in visit_calls(dev).items():
            calls[key] = (call, check, tests)
            visit_args[key] = a
    sums = {key: check(call()) for key, (call, check, _) in calls.items()}
    turns = {key: [] for key in calls}
    for key in [*calls, *reversed(calls)]:
        turns[key].append(device_ms(calls[key][0]))
    # the SM clock under load: the soup's MT nearest hit (~1 ms a launch),
    # else K8's full walk, some 300 ms of launches queued per read
    load = ("K3", "soup 4095 x 65536")
    if load not in calls:
        load = next(iter(visit_args), next(iter(calls)))
    mhz = sm_clock_mhz(calls[load][0],
                       burst=max(5, int(300 / np.mean(turns[load]))))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  SM clock under load: {mhz:.0f} MHz (max "
          f"{_smi('clocks.max.sm')}); {sms} SMs", flush=True)
    rows = []
    for (kernel, shape), ms in turns.items():
        mean = sum(ms) / len(ms)
        tests = calls[(kernel, shape)][2]
        # warp-instruction slots (4 schedulers per SM) per 32 tests
        slots = (mean * 1e-3 * sms * 4 * mhz * 1e6 / (tests / 32)
                 if tests else None)
        row = {"kernel": kernel, "shape": shape, "ms": mean, "turns": ms,
               "checksum": sums[(kernel, shape)], "tests": tests,
               "slots_per_test": slots}
        per_test = f"; {tests} tests, {slots:.1f} warp-instruction slots per test" \
            if tests else ""
        if (kernel, shape) in visit_args:
            row["sms"] = visit_sms(visit_args[(kernel, shape)])
            per_test += f"; SMs occupied {row['sms']}"
        rows.append(row)
        print(f"  {kernel} {shape}: device ms {ms[0]:.4f} {ms[1]:.4f} "
              f"(mean {mean:.4f}); checksum {sums[(kernel, shape)]!r}"
              f"{per_test}", flush=True)
    result = {"label": args.label, "device": smi, "sm_mhz": mhz,
              "kernels": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
