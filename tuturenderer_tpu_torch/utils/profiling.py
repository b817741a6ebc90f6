"""Tracing, profiling and throughput counters.

The port of ``tuturenderer_tpu/utils/profiling.py``. The reference's only
instrumentation is wall-clock ``std::chrono`` spans around BVH build and
render plus a console progress bar (BVH.hpp:32-37, global.hpp:202-213,
main.cpp:90-102). Here:

- ``Profiler.phase(name)``: a wall-clock span synchronised with the card
  at both edges, so it measures the work inside the block and not the
  enqueue (on the CPU there is nothing to wait for);
- ``rays_per_path``, ``RenderStats`` and ``measure_render``: rays/s and
  paths/s accounting for a render;
- ``trace(logdir)``: a ``torch.profiler`` trace of the host's operators
  and the card's kernels, written into ``logdir`` as a Chrome trace;
- ``progress``: the console progress bar (showProgress,
  global.hpp:202-213).

``utils/timing.py`` (device time of one kernel call between CUDA events)
is a separate tool and stays as it is.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


@dataclass
class PhaseRecord:
    name: str
    seconds: float


@dataclass
class Profiler:
    """Collects named phase timings; print with ``report()``."""
    records: List[PhaseRecord] = field(default_factory=list)
    enabled: bool = True

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        """Time a block. ``sync=True`` waits for the card's queued work at
        both edges so the span measures the work inside the block, not
        the enqueue."""
        if not self.enabled:
            yield
            return
        if sync:
            _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync()
            self.records.append(PhaseRecord(name, time.perf_counter() - t0))

    def report(self, file=None) -> Dict[str, float]:
        """Print a per-phase table; returns {name: seconds} totals."""
        file = file or sys.stderr
        totals: Dict[str, float] = {}
        for r in self.records:
            totals[r.name] = totals.get(r.name, 0.0) + r.seconds
        width = max((len(n) for n in totals), default=4)
        for name, sec in totals.items():
            print(f"  {name:<{width}}  {sec:8.3f}s", file=file)
        return totals


def _sync():
    """Wait for the card's queued work, where this process has used the
    card; nothing on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the block: the host's operators and,
    where there is a card, its kernels. Written to ``logdir/trace.json``
    (Chrome trace format: chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def rays_per_path(max_depth: int, alive_fractions=None,
                  epilogue: float = 0.1, nee: bool = True) -> float:
    """Estimated rays traced per camera path: each live bounce costs one
    scene intersection plus one NEE shadow ray; the epilogue resolves the
    final pending emissive hit. ``alive_fractions`` defaults to all-alive
    (an upper bound); pass measured per-bounce live fractions
    (``trace_rays(collect_alive=True)``) for honest accounting."""
    if alive_fractions is None:
        alive_fractions = [1.0] * (max_depth + 1)
    per_bounce = 2.0 if nee else 1.0
    return per_bounce * float(sum(alive_fractions)) + epilogue


@dataclass
class RenderStats:
    wall_s: float
    paths: int
    rays: float

    @property
    def rays_per_sec(self) -> float:
        return self.rays / max(self.wall_s, 1e-12)

    @property
    def paths_per_sec(self) -> float:
        return self.paths / max(self.wall_s, 1e-12)

    def __str__(self):
        return (f"{self.wall_s:.3f}s, {self.paths/1e6:.2f}M paths "
                f"({self.paths_per_sec/1e6:.1f} M paths/s, "
                f"~{self.rays_per_sec/1e6:.0f} M rays/s)")


def measure_render(fn, width: int, height: int, spp: int, max_depth: int,
                   alive_fractions=None) -> RenderStats:
    """Run ``fn()`` (a render call), wait for the card, and derive
    throughput counters."""
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    wall = time.perf_counter() - t0
    paths = width * height * spp
    rays = paths * rays_per_path(max_depth, alive_fractions)
    return RenderStats(wall_s=wall, paths=paths, rays=rays)


def progress(done: int, total: int, width: int = 60, file=None) -> None:
    """Console progress bar (showProgress, global.hpp:202-213)."""
    file = file or sys.stdout
    frac = done / max(total, 1)
    bar = int(width * frac)
    print("\r[" + "=" * bar + ">" + " " * (width - bar) +
          f"] {int(100 * frac)} %", end="" if done < total else "\n",
          file=file, flush=True)
