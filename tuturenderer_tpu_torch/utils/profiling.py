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
  global.hpp:202-213);
- ``span(name)``, ``spanned(name)`` and ``unit(name)``: named host spans
  at the port's layer boundaries (below), kept in memory.

``utils/timing.py`` (device time of one kernel call between CUDA events)
is a separate tool and stays as it is.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
        the enqueue. The block is also a ``span`` of the same name, so
        it shows on a trace's timeline."""
        if not self.enabled:
            yield
            return
        if sync:
            _sync()
        t0 = time.perf_counter()
        try:
            with span(name):
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


# ------------------------------------------------------------------ spans
#
# A span is a named stretch of host time at one of the port's layer
# boundaries (``integrators/path.py``'s bounce loop, ``ops/intersect.py``'s
# queries, the shading functions, ``utils/rng.py``, ``grad.py``'s replay).
# Spans record while a ``torch.profiler`` is active or inside
# ``recording()``; while one is active each also enters the profiler's
# ``record_function``, so it sits on the kernels' timeline in the trace and
# the profiler ties each kernel to the span that launched it. Otherwise a
# span site costs one test and hands back the shared ``OFF``. The recorder
# keeps closed spans in a bounded buffer in memory and writes nothing.

SPAN_BUFFER = 1 << 17           # closed spans kept; the oldest go first

_profiler_enabled = torch.autograd._profiler_enabled
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


class SpanRecord:
    """One span. ``parent`` and ``root`` are ``sid``s: the span open
    around it (None at the top) and the unit it belongs to (the innermost
    ``unit`` span around it, or itself; None outside every unit).
    ``start_ns`` and ``end_ns`` are ``time.time_ns()``, the clock of the
    profiler's host events. ``counts`` holds what the site attached:
    Python ints, or 0-d tensors on the device to be read after a sync."""
    __slots__ = ("name", "sid", "parent", "root", "start_ns", "end_ns",
                 "counts", "thread")

    def __init__(self, name: str, sid: int, thread: int):
        self.name, self.sid, self.thread = name, sid, thread
        self.parent = self.root = None
        self.start_ns = self.end_ns = 0
        self.counts = {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, sid={self.sid}, "
                f"parent={self.parent}, root={self.root}, "
                f"{self.duration_ns} ns, {self.counts})")


class Recorder:
    """The spans of one process: the closed ones in a bounded buffer, one
    stack of open ones per thread, and the first span of each unit name
    (kept whatever the buffer drops)."""

    def __init__(self, capacity: int = SPAN_BUFFER):
        self.spans = collections.deque(maxlen=capacity)
        self.firsts: Dict[str, SpanRecord] = {}
        self.depth = 0              # open recording() blocks, first calls
        self._stacks: Dict[int, list] = {}
        self._seen = set()          # unit names called once already
        self._next = 0
        self._lock = threading.Lock()

    def enable(self, step: int) -> None:
        with self._lock:
            self.depth += step

    def first_call(self, name: str) -> bool:
        """True once per unit name: the caller's call is its first."""
        with self._lock:
            first = name not in self._seen
            self._seen.add(name)
        return first

    def open(self, name: str, unit: bool) -> SpanRecord:
        tid = threading.get_ident()
        with self._lock:
            stack = self._stacks.setdefault(tid, [])
            parent = stack[-1] if stack else self._waited_on(tid)
            rec = SpanRecord(name, self._next, tid)
            self._next += 1
        if parent is not None:
            rec.parent, rec.root = parent.sid, parent.root
        if unit:
            rec.root = rec.sid
        stack.append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def _waited_on(self, tid: int) -> Optional[SpanRecord]:
        """The innermost open span of the thread this one works for, the
        latest opened of the other threads' innermost spans: the autograd
        engine runs a card's backward pass on a thread of its own while
        the caller waits in ``torch.autograd.grad``."""
        tops = [s[-1] for t, s in self._stacks.items() if t != tid and s]
        return max(tops, key=lambda r: r.start_ns, default=None)

    def close(self, rec: SpanRecord, unit: bool) -> None:
        rec.end_ns = time.time_ns()
        stack = self._stacks[rec.thread]
        if stack[-1] is rec:
            stack.pop()
        else:
            stack.remove(rec)
        self.spans.append(rec)
        if unit and rec.name not in self.firsts:
            self.firsts[rec.name] = rec


RECORDER = Recorder()


class _Off:
    """The span every site hands back while nothing records."""
    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, value) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "unit", "first", "rec", "_rf")
    on = True

    def __init__(self, name: str, unit: bool = False, first: bool = False):
        self.name, self.unit, self.first = name, unit, first
        self.rec = self._rf = None

    def __enter__(self):
        if self.first:
            RECORDER.enable(1)
        self.rec = RECORDER.open(self.name, self.unit)
        if _profiler_enabled():
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        RECORDER.close(self.rec, self.unit)
        if self.first:
            RECORDER.enable(-1)
        return False

    def count(self, key: str, value) -> None:
        """Attach a number to the span: an int, or a 0-d device tensor
        that the reader takes after its own sync."""
        self.rec.counts[key] = value


def span(name: str):
    """A span named ``name`` around a block (``with span("bounce") as
    sp: sp.count("depth", depth)``). Names are dotted, and none starts
    with ``cu`` (the prefix of the CUDA runtime's host events)."""
    if not (RECORDER.depth or _profiler_enabled()):
        return OFF
    return _Span(name)


def unit(name: str):
    """``span`` for a root entry point, one unit of work (``render``, a
    ``step``): the spans inside it take it as their root. The first call
    of each unit name in the process is recorded whole, profiler or not:
    it is set-up, and its spans split the set-up time."""
    if name not in RECORDER._seen and RECORDER.first_call(name):
        return _Span(name, unit=True, first=True)
    if not (RECORDER.depth or _profiler_enabled()):
        return OFF
    return _Span(name, unit=True)


def spanned(name: str):
    """The decorator form of ``span``: a span around every call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (RECORDER.depth or _profiler_enabled()):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    RECORDER.enable(1)
    try:
        yield RECORDER
    finally:
        RECORDER.enable(-1)


def recording_on() -> bool:
    """True where a span would record: a profiler is active, or a
    ``recording()`` block or a unit's first call is open."""
    return bool(RECORDER.depth or _profiler_enabled())


@contextlib.contextmanager
def paused():
    """Record no span inside the block, outside a profiler, whatever
    records around it (a CUDA graph's capture: its launches run later)."""
    with RECORDER._lock:
        depth, RECORDER.depth = RECORDER.depth, 0
    try:
        yield
    finally:
        RECORDER.enable(depth)


def recorded() -> List[SpanRecord]:
    """The closed spans the buffer holds, oldest first (a span closes
    after the spans inside it)."""
    return list(RECORDER.spans)


def first_unit(name: str) -> Optional[SpanRecord]:
    """The process's first span of the unit ``name``, or None."""
    return RECORDER.firsts.get(name)


def live_lanes(mask: torch.Tensor) -> torch.Tensor:
    """The lanes ``mask`` lets through, a 0-d int64 tensor on its device
    (on the card two launches, the cast to int64 and the sum; no sync):
    the port's one count of live lanes."""
    return mask.sum()


def count_lanes(sp, lanes: int, mask) -> None:
    """Attach to an intersection query's span the lanes it was launched
    with (``lanes``) and those its ``mask`` lets through (``live``; every
    lane without a mask). Nothing, and no launch, while ``sp`` is off."""
    if sp.on:
        sp.count("lanes", lanes)
        sp.count("live", lanes if mask is None else live_lanes(mask))
