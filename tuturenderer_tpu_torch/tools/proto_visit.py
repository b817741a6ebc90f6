"""The visit-list walk probe: a cluster traversal over per-tile visit
lists, with a tile-wide early exit.

The port of ``tools/proto_visit.py``, the TPU prototype of the mechanisms
a redesigned cluster intersector needs. ``run`` launches its CUDA kernel
(``csrc/proto_visit.cu``) on CUDA tensors and runs its plain PyTorch
version ``run_plain`` on CPU tensors; ``main`` runs the prototype's two
scenarios on the card:

    python -m tuturenderer_tpu_torch.tools.proto_visit

A tile is 1024 rays. Each tile walks its own visit list of ``nc`` cluster
ids (``vlist``) with entry distances (``ventry``) in groups of 4 clusters,
testing the 64 planes of each cluster (slots 8-11 of its Woop rows: r3, c3)
and keeping the nearest, until the next group's entry is no nearer than the
tile's limit: the least, over the groups walked, of the tile's farthest
live best hit.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda.intersect import F32_MAX, LAUNCHES, _raise_on, refuse_grad
from ..utils.device import DEFAULT_DEVICE, resolve

TILE = 1024          # rays per tile (8 x 128 lanes on the TPU)
G = 4                # clusters per group
CS = 64              # planes per cluster
WF = 14              # floats per Woop row
ROW = 1024           # floats per cluster row (8 x 128)
SENTINEL = 3.0e37    # an entry at or above it is not visited
MIN_WD = 1e-6        # |w_d| below it: the ray is parallel to the plane

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("proto_visit")
    if lib.visit_walk.argtypes is None:
        lib.visit_walk.argtypes = [_P] * 10 + [_I, _I] + [_P] * 3
        lib.visit_walk.restype = _I
        lib.visit_walk_sm_ids.argtypes = [_P] * 10 + [_I, _I] + [_P] * 4
        lib.visit_walk_sm_ids.restype = _I
        lib.visit_walk_ctas.argtypes = []
        lib.visit_walk_ctas.restype = _I
    return lib


def _check(vlist, ventry, rays, woop, nc: int) -> int:
    """Validate the inputs; returns the tile count."""
    n = rays[0].shape[0]
    if n == 0 or n % TILE:
        raise ValueError(f"{n} rays: a positive multiple of {TILE}")
    if nc <= 0 or nc % G:
        raise ValueError(f"nc = {nc}: a positive multiple of {G}")
    n_tiles = n // TILE
    want = [(vlist, torch.int32, (n_tiles * nc,)),
            (ventry, torch.float32, (n_tiles * nc,))] + \
        [(c, torch.float32, (n,)) for c in rays]
    for a, dtype, shape in want:
        if a.dtype != dtype or tuple(a.shape) != shape or \
                not a.is_contiguous():
            raise ValueError(f"{a.dtype} {tuple(a.shape)}: expected a "
                             f"contiguous {dtype} {shape}")
    if woop.dtype != torch.float32 or woop.dim() != 2 or \
            woop.shape[1] != ROW or not woop.is_contiguous():
        raise ValueError(f"woop {woop.dtype} {tuple(woop.shape)}: expected "
                         f"a contiguous float32 [clusters, {ROW}]")
    for a in (ventry, *rays, woop):
        if a.device != vlist.device:
            raise ValueError(f"tensors on {a.device} and {vlist.device}")
    refuse_grad((ventry, *rays, woop))
    if int(vlist.min()) < 0 or int(vlist.max()) >= woop.shape[0]:
        raise ValueError("a visit list names a cluster outside woop")
    return n_tiles


def run(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc: int):
    """Nearest plane hit per ray by the visit-list walk -> (t float32 [N],
    idx int32 [N]); t = 3.4e38 and idx = -1 where no plane was hit.

    ``vlist`` int32 / ``ventry`` float32 [n_tiles * nc] (tile-major), the
    rays, ``live`` (> 0 for a live lane) float32 [N] with N = 1024 *
    n_tiles, ``woop`` float32 [clusters, 1024]."""
    rays = (ox, oy, oz, dx, dy, dz, live)
    n_tiles = _check(vlist, ventry, rays, woop, nc)
    if vlist.device.type == "cpu":
        return run_plain(vlist, ventry, *rays, woop, nc)
    if vlist.device.type != "cuda":
        raise ValueError(f"no visit-walk kernel for {vlist.device}")
    return _launch(vlist, ventry, rays, woop, nc, n_tiles)


def _launch(vlist, ventry, rays, woop, nc: int, n_tiles: int, sm_out=None):
    """``run``'s launch on CUDA inputs that ``_check`` passed (it reads the
    visit lists on the host, so ``run`` synchronises; this does not). With
    ``sm_out`` (int32 [n_tiles * CTAs per tile]) the kernel also writes the
    SM each CTA ran on there."""
    ox = rays[0]
    t = torch.empty_like(ox)
    idx = torch.empty(ox.shape[0], dtype=torch.int32, device=ox.device)
    lib = _lib()
    with torch.cuda.device(ox.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (vlist.data_ptr(), ventry.data_ptr(),
                *(c.data_ptr() for c in rays), woop.data_ptr(), nc, n_tiles,
                t.data_ptr(), idx.data_ptr())
        err = lib.visit_walk(*args, stream) if sm_out is None else \
            lib.visit_walk_sm_ids(*args, sm_out.data_ptr(), stream)
    _raise_on(err, "visit_walk")
    LAUNCHES["proto_visit"] += 1
    return t, idx


def sm_ids(vlist, ventry, rays, woop, nc: int, n_tiles: int):
    """The SM each CTA of one launch ran on, int32 [n_tiles * CTAs per
    tile], from the kernel itself (``%smid``)."""
    sms = torch.empty(n_tiles * _lib().visit_walk_ctas(), dtype=torch.int32,
                      device=rays[0].device)
    _launch(vlist, ventry, rays, woop, nc, n_tiles, sms)
    return sms


def walk_plain(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc: int):
    """The plain PyTorch walk -> (t, idx, groups walked per tile). All tiles
    step through their groups together; a tile whose walk has ended keeps
    its results, so each tile's result is that of its own walk, dead lanes
    included. Within a group the first plane at the least t wins, as the
    kernel's strict < does."""
    n_tiles = ox.shape[0] // TILE
    dev = ox.device
    vl = vlist.reshape(n_tiles, nc).long()
    ve = ventry.reshape(n_tiles, nc)
    r = [c.reshape(n_tiles, TILE, 1) for c in (ox, oy, oz, dx, dy, dz)]
    lv = live.reshape(n_tiles, TILE) > 0.0
    rows = woop[:, :CS * WF].reshape(-1, CS, WF)[:, :, 8:12]   # [C, 64, 4]
    t_best = torch.full((n_tiles, TILE), F32_MAX, dtype=torch.float32,
                        device=dev)
    idx = torch.full((n_tiles, TILE), -1, dtype=torch.int64, device=dev)
    t_lim = torch.full((n_tiles,), F32_MAX, dtype=torch.float32, device=dev)
    groups = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    ng = nc // G
    for s in range(ng):
        active = ve[:, s * G] < t_lim
        if not bool(active.any()):
            break
        p = torch.clamp(torch.arange(s * G, s * G + G, device=dev),
                        max=nc - 1)
        cid = vl[:, p]                                     # [tiles, G]
        valid = (ve[:, p] < SENTINEL)[:, :, None].expand(-1, -1, CS)
        pl = rows[cid].reshape(n_tiles, 1, G * CS, 4)
        w_o = r[0] * pl[..., 0] + r[1] * pl[..., 1] + r[2] * pl[..., 2] \
            - pl[..., 3]
        w_d = r[3] * pl[..., 0] + r[4] * pl[..., 1] + r[5] * pl[..., 2]
        t = -w_o / w_d
        ok = valid.reshape(n_tiles, 1, G * CS) & (w_d.abs() >= MIN_WD) & \
            (t > 0.0)
        t = torch.where(ok, t, F32_MAX)
        j = torch.argmin(t, dim=2, keepdim=True)
        t_min = t.gather(2, j)[..., 0]
        plane = cid.gather(1, j[..., 0] // CS) * CS + j[..., 0] % CS
        better = active[:, None] & (t_min < t_best)
        t_best = torch.where(better, t_min, t_best)
        idx = torch.where(better, plane, idx)
        tile_max = torch.where(lv, t_best, 0.0).max(dim=1).values
        t_lim = torch.where(active, torch.minimum(t_lim, tile_max), t_lim)
        groups = groups + active.long()
    return t_best.reshape(-1), idx.to(torch.int32).reshape(-1), groups


def run_plain(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc: int):
    """Plain PyTorch version of ``run``."""
    return walk_plain(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop,
                      nc)[:2]


def scenario(name: str, nc: int, n_tiles: int, seed: int = 0) -> dict:
    """The prototype's inputs (tools/proto_visit.py main) as numpy arrays,
    rays from z = -1 along +z, every lane live:

    - "early": cluster c holds planes at z = c + k/64, the visit list is
      0..nc-1 with entries c + 1 and its back half unreachable (entries
      3.4e38): every ray hits cluster 0's plane 0 at t = 1 and the walk
      ends after its first group;
    - "full": only the last cluster holds planes (z = 5), entries rise from
      0.1 to 4.9: every group is walked and t = 6;
    - "special": the planes at the arithmetic's edges (``special_planes``).
    """
    if name == "special":
        return special_planes(nc, n_tiles, seed)
    rng = np.random.default_rng(seed)
    n = n_tiles * TILE
    k = np.arange(CS)
    woop = np.zeros((nc, ROW), np.float32)
    if name == "early":
        woop[:, k * WF + 10] = 1.0
        woop[:, k * WF + 11] = np.arange(nc)[:, None] + k[None, :] / CS
        vlist = np.tile(np.arange(nc, dtype=np.int32), (n_tiles, 1))
        ventry = np.tile((np.arange(nc) + 1.0).astype(np.float32),
                         (n_tiles, 1))
        ventry[:, nc // 2:] = 3.4e38
        vlist[:, nc // 2:] = 0
    elif name == "full":
        woop[nc - 1, k * WF + 10] = 1.0
        woop[nc - 1, k * WF + 11] = 5.0
        vlist = np.tile(np.arange(nc, dtype=np.int32), (n_tiles, 1))
        ventry = np.tile(np.linspace(0.1, 4.9, nc).astype(np.float32),
                         (n_tiles, 1))
    else:
        raise ValueError(f"scenario {name!r}: 'early', 'full' or 'special'")
    return dict(
        vlist=vlist.reshape(-1), ventry=ventry.reshape(-1),
        ox=rng.standard_normal(n).astype(np.float32),
        oy=rng.standard_normal(n).astype(np.float32),
        oz=np.full(n, -1.0, np.float32), dx=np.zeros(n, np.float32),
        dy=np.zeros(n, np.float32), dz=np.ones(n, np.float32),
        live=np.ones(n, np.float32), woop=woop)


N_SPECIAL = 16       # clusters of the special-planes scenario
NEAR = 15            # its cluster of near planes, named only by skipped entries
F32 = np.float32


def _special_rows(rng) -> np.ndarray:
    """[16, 64, 4] planes (r3x r3y r3z c3) of ``special_planes``: every
    value but the special rows' on a grid of 1/64, so every product and
    sum of a test is exact and only the division rounds."""
    tiny = F32(1e-6)
    rows = np.zeros((N_SPECIAL, CS, 4), F32)
    for c in range(N_SPECIAL):
        z0 = F32(-0.9375) if c == NEAR else F32(-0.5 + c / 8)
        rows[c, :, 0:2] = rng.integers(-4, 5, (CS, 2)) / 8
        rows[c, :, 2] = 1.0
        rows[c, :, 3] = z0 + rng.integers(0, 20, CS) / 64
        if c == NEAR:
            rows[c, :, :2] = 0.0
            rows[c, :, 3] = z0
            continue
        special = [
            (0.0, 0.0, 1.0, z0),                     # horizontal, z = z0
            (0.0, 0.0, 1.0, z0),                     # its exact tie
            (0.0, 0.0, 0.0, 0.5),                    # w_d = +0
            (-1.0, -1.0, -0.0, 0.0),                 # w_d = -0 along +z
            (0.0, 0.0, 1e-40, 0.0),                  # subnormal w_d
            (0.0, 0.0, np.nextafter(tiny, F32(0)), 2e-6),   # just below 1e-6
            (0.0, 0.0, tiny, 2e-6),                  # at 1e-6: t = 2 or 3
            (0.0, 0.0, np.nextafter(tiny, F32(1)), 2.5e-6),  # just above
            (0.0, 0.0, np.inf, 0.0),                 # w_d = inf
            (0.0, 0.0, 1.0, np.inf),                 # t = inf
            (0.0, 0.0, 1.0, -np.inf),                # t = -inf
            (np.inf, 0.0, 1.0, 0.0),                 # 0 * inf: w_d NaN
            (0.0, 0.0, np.nan, 0.0),                 # w_d NaN
            (0.0, 0.0, 1.0, np.nan),                 # w_o NaN
        ]
        if c == 5:
            special.append((0.0, 0.0, 1.0, 1e-39))   # subnormal t from z = 0
        rows[c, :len(special)] = np.array(special, F32)
    return rows


def special_planes(nc: int, n_tiles: int, seed: int = 0) -> dict:
    """Planes and rays at the edges of the plane test's arithmetic, in 16
    clusters: w_d = +0 and -0, subnormal, just below, at and just above
    1e-6, inf and NaN rows, an exact tie, a plane at a subnormal c3 (a ray
    from z = 0 meets it at a subnormal t), beside tilted planes. A tile's
    visit list names the clusters in a rotated order with sentinel entries
    between valid ones (at and just below 3e37, and 3.4e38), the skipped
    ones naming the cluster of nearest planes; its entries rise so that
    the walk ends on t_lim after its third group; the entries past 16 are
    3.4e38. Rays: along (0, 0, 1) from z = -1 and from z = 0 (every 8th),
    along (-0, -0, 1), and tilted (d = (a, b, 1)), every coordinate on a
    grid of 1/16 or 1/8. Tile 1, if any, is wholly dead."""
    if nc < N_SPECIAL or nc % G:
        raise ValueError(f"nc = {nc}: the special planes take >= 16")
    rng = np.random.default_rng(seed)
    woop = np.zeros((N_SPECIAL, ROW), F32)
    k = np.arange(CS)
    rows = _special_rows(rng)
    for j in range(4):
        woop[:, k * WF + 8 + j] = rows[:, :, j]
    order = np.array([0, NEAR, 1, 2, 3, NEAR, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                      13])
    entry = np.array([0.1, 3e37, 0.15, np.nextafter(F32(3e37), F32(0)),
                      0.2, 3.4e38, 0.25, 0.3, 0.4, 0.42, 0.44, 0.46, 50.0,
                      51.0, 52.0, 53.0], F32)
    vlist = np.zeros((n_tiles, nc), np.int32)
    ventry = np.full((n_tiles, nc), 3.4e38, F32)
    for t in range(n_tiles):
        vlist[t, :N_SPECIAL] = np.where(order == NEAR, NEAR,
                                        (order + t) % NEAR)
        ventry[t, :N_SPECIAL] = entry
    n = n_tiles * TILE
    lane = np.arange(n) % 8
    ox = (rng.integers(-32, 33, n) / 16).astype(F32)
    oy = (rng.integers(-32, 33, n) / 16).astype(F32)
    oz = np.where(lane == 7, F32(0.0), F32(-1.0)).astype(F32)
    d = np.zeros((n, 3), F32)
    d[:, 2] = 1.0
    d[lane == 4, :2] = -0.0
    tilted = (lane == 5) | (lane == 6)
    d[tilted, :2] = rng.integers(-4, 5, (int(tilted.sum()), 2)) / 8
    live = np.ones(n, F32)
    live[TILE:2 * TILE] = 0.0
    return dict(vlist=vlist.reshape(-1), ventry=ventry.reshape(-1), ox=ox,
                oy=oy, oz=oz, dx=np.ascontiguousarray(d[:, 0]),
                dy=np.ascontiguousarray(d[:, 1]),
                dz=np.ascontiguousarray(d[:, 2]), live=live, woop=woop)


ARGS = ("vlist", "ventry", "ox", "oy", "oz", "dx", "dy", "dz", "live", "woop")

# the answer each scenario asserts (tools/proto_visit.py:192-193, 217)
EXPECT = {"early": (1.0, 1e-5, 0), "full": (6.0, 1e-4, None)}


def tensors(arrays: dict, device) -> list:
    """A scenario's arrays as ``run``'s positional tensors on ``device``."""
    return [torch.from_numpy(arrays[k]).to(device) for k in ARGS]


def check(name: str, t: torch.Tensor, idx: torch.Tensor):
    """Raise unless every ray got the scenario's asserted answer."""
    want_t, atol, want_idx = EXPECT[name]
    err = (t - want_t).abs().max().item()
    if err > atol:
        raise AssertionError(f"{name}: max |t - {want_t}| = {err}")
    if want_idx is not None and not bool((idx == want_idx).all()):
        raise AssertionError(f"{name}: idx differs from {want_idx}")


def main(nc: int = 1024, n_tiles: int = 64, reps: int = 10,
         device=DEFAULT_DEVICE) -> dict:
    """Run both scenarios at the prototype's size on the card: each once
    against its asserted answer, then ``reps`` timed launches. Returns
    {scenario: mean ms per launch}."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("main times the kernel: it needs a CUDA device")
    out = {}
    for name in ("early", "full"):
        args = tensors(scenario(name, nc, n_tiles), dev)
        t, idx = run(*args, nc=nc)
        check(name, t, idx)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            run(*args, nc=nc)
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / reps
        print(f"{name}: t[:4]={t[:4].tolist()} idx[:4]={idx[:4].tolist()} "
              f"{out[name]:.4f} ms per launch ({reps} launches, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms of wall)",
              flush=True)
    print("CORRECT: early exit and full visit-list walk", flush=True)
    return out


if __name__ == "__main__":
    main()
