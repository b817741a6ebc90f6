"""The traced run: a profiler trace of a few passes or steps, digested.

``capture`` runs ``trace_units`` units of the cell's loop (passes or
steps, counted into the run's work like any other) under
``torch.profiler`` with the host and the card, and reduces the trace in
memory; nothing is written to disk. The profiler has been seen to drop
device records on long windows, so the capture checks itself: the device
records of the intersection kernels (K1/K2 ``woop_*_kernel``, K5/K6
``bvh_walk_kernel``) must equal the launches the program counted on the
host (``ops/cuda/intersect.py::LAUNCHES``). Where they differ it says so on
standard error and traces again with half the units, down to one; a trace
that never agrees is marked incomplete, and the readers of idle share and
rooflines then report nothing.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
from typing import Dict, List, Tuple

import torch

# device-record name fragment -> the program's launch counter
KERNELS = {"woop_nearest_kernel": "nearest", "woop_anyhit_kernel": "anyhit",
           "bvh_walk_kernel<0>": "cluster_nearest",
           "bvh_walk_kernel<1>": "cluster_anyhit"}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaLaunchCooperativeKernel")
TOP = 10


@dataclasses.dataclass
class Digest:
    units: int
    unit_seconds: List[float]
    window_s: float
    busy_s: float
    host_launches: int
    kernels: Dict[str, Tuple[int, float]]    # fragment -> (records, seconds)
    launches: Dict[str, int]                 # the program's counters
    complete: bool
    host_spans: Dict[str, float]             # name -> seconds, union
    breakdown: dict
    peak_bytes: int


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def digest_events(events, t0_ns: int, t1_ns: int, span_names=()):
    """Reduce raw profiler events over the window [t0_ns, t1_ns]."""
    dev, host = [], []
    for ev in events:
        (dev if _is_device(ev) else host).append(ev)
    busy, merged = _union((max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns))
                          for e in dev if e.end_ns() > t0_ns and
                          e.start_ns() < t1_ns)
    by_name = collections.defaultdict(float)
    kernels = {k: [0, 0.0] for k in KERNELS}
    for e in dev:
        sec = e.duration_ns() * 1e-9
        by_name[e.name()] += sec
        for frag in KERNELS:
            if frag in e.name():
                kernels[frag][0] += 1
                kernels[frag][1] += sec
    launches = sum(1 for e in host if e.name() in LAUNCH_CALLS)
    spans = {}
    for name in span_names:
        spans[name] = _union((e.start_ns(), e.end_ns()) for e in host
                             if e.name().endswith(name))[0] * 1e-9
    # idle gaps, each put to the innermost host operator running at its
    # middle (the latest-starting one that covers it)
    ops = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                 if not e.name().startswith(("cuda", "cu")))
    starts = [o[0] for o in ops]
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    gaps = collections.defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = "(no host operator)"
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 200), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        gaps[name] += (b - a) * 1e-9
    top = lambda d: [[n[:160], v] for n, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(busy_s=busy * 1e-9, host_launches=launches,
                kernels={k: tuple(v) for k, v in kernels.items()},
                host_spans=spans,
                breakdown={"device_ops": top(by_name),
                           "idle_gaps": top(gaps)})


def _trace(loop, state, n: int, span_names):
    from torch.profiler import ProfilerActivity, profile
    from tuturenderer_tpu_torch.ops.cuda.intersect import LAUNCHES
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = [loop.unit(state) for _ in range(n)]
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    events = prof.profiler.kineto_results.events()
    # the traced window: from the first host record to the last
    host = [e for e in events if not _is_device(e)]
    t0 = min(e.start_ns() for e in host)
    t1 = max(e.end_ns() for e in host)
    d = digest_events(events, t0, t1, span_names)
    counted = {k: LAUNCHES[v] - before[v] for k, v in KERNELS.items()}
    return Digest(units=n, unit_seconds=secs, window_s=(t1 - t0) * 1e-9,
                  busy_s=d["busy_s"], host_launches=d["host_launches"],
                  kernels=d["kernels"], launches=counted, complete=True,
                  host_spans=d["host_spans"], breakdown=d["breakdown"],
                  peak_bytes=peak)


def capture(loop, state, units: int,
            span_names=("_RenderDiffBackward",)) -> Digest:
    """Trace ``units`` units (fewer where records were dropped)."""
    state.info["peak_before_trace"] = torch.cuda.max_memory_allocated()
    n = max(1, units)
    while True:
        dg = _trace(loop, state, n, span_names)
        kept = {k: dg.kernels[k][0] for k in KERNELS}
        if kept == dg.launches:
            return dg
        print(f"trace: device records {kept} differ from the launches "
              f"counted {dg.launches} over {n} unit(s)", file=sys.stderr)
        if n == 1:
            dg.complete = False
            return dg
        n //= 2
