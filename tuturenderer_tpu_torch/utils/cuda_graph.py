"""CUDA graphs of the port's eager code, with its launch counters kept.

A wavefront of eager PyTorch is tens of thousands of small launches, each
dispatched by the host: BDPT's wavefront of 1,048,576 lanes is ~22,300 of
them. ``Graph`` records them once and replays them with one host call. A
replay reads and writes the device memory the capture saw, so the caller
keeps the capture's inputs and outputs alive and writes new inputs into
them in place.

The port counts its kernels' launches in Python
(``ops/cuda/intersect.py::LAUNCHES``, ``utils/rng.py::LAUNCHES``), and a
replay runs no Python. So the capture, which launches nothing, takes back
what it counted, and each replay adds it. No span records while capturing.

``run`` drives the wavefronts of one render over this, as its frame
(``integrators/frame.py``) schedules them: a scene keeps one capture an
integrator (the path tracer's ``"path"``, BDPT's ``"bdpt"``), for the key
of one frame, taken after an eager wavefront, which loads every kernel,
and dropped with the scene. A wavefront runs eagerly while spans record
(a profiler, ``recording()``), so that they see every op; where the caller
rules graphs out (off the card, ``differentiable`` options, a seed or
sample base that is not an int: ``eligible``); where a scene or camera
tensor requires grad; where the capture failed; and under ``ON = False``.
``REPLAYED`` and ``EAGER`` count the wavefronts each integrator replayed
and ran eagerly.
"""
from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Dict, List, Tuple

import torch

from . import profiling

Counts = Tuple[Dict[str, int], int]


def _counts() -> Counts:
    from ..ops.cuda import intersect
    from . import rng
    return dict(intersect.LAUNCHES), rng.LAUNCHES


def _set(counts: Counts) -> None:
    from ..ops.cuda import intersect
    from . import rng
    intersect.LAUNCHES.update(counts[0])
    rng.LAUNCHES = counts[1]


class Graph:
    """The launches of ``fn()`` on ``device``, captured once; ``out`` is
    what that call returned. Capture outside a profiler: a capture runs
    nothing, and spans would time it.

    The capture takes its memory in a pool of its own. The eager blocks
    cached beside it stay (so an eager call after it allocates nothing
    anew), unless the card lacks room for the capture, which needs about
    what the cache holds."""

    def __init__(self, fn, device):
        self.device = device
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            free, _ = torch.cuda.mem_get_info()
            if free < torch.cuda.memory_reserved():
                torch.cuda.empty_cache()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            try:
                with profiling.paused(), torch.cuda.stream(stream):
                    self.graph.capture_begin()
                    try:
                        self.out = fn()
                    finally:
                        self.graph.capture_end()
                kernels, draws = _counts()
                self.launches = ({k: n - before[0].get(k, 0)
                                  for k, n in kernels.items()},
                                 draws - before[1])
            finally:
                torch.cuda.current_stream().wait_stream(stream)
                _set(before)

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels, draws = _counts()
        _set(({k: kernels.get(k, 0) + n for k, n in self.launches[0].items()},
              draws + self.launches[1]))


# ------------------------------------------------------- captured wavefronts

ON = True           # False: every wavefront eager (tools that wrap kernels)
REPLAYED = {"path": 0, "bdpt": 0}     # wavefronts replayed, by integrator
EAGER = {"path": 0, "bdpt": 0}        # wavefronts run eagerly, by integrator
_CAPTURED: Dict[Tuple[int, str], "Captured"] = {}  # (id(scene), integrator)


def eligible(dev, opts, seed, sample_base) -> bool:
    """Whether a render's wavefronts may replay at all: on the card, with
    the switch on, options that are not ``differentiable``, and a seed and
    sample base that are ints (a capture keys its seed as a value)."""
    return ON and dev.type == "cuda" and not opts.differentiable and \
        type(seed) is int and type(sample_base) is int


def leaves(obj) -> List[torch.Tensor]:
    """The tensors of a scene or camera (dataclasses, tuples of them)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in leaves(v)]
    return []


class Captured:
    """One wavefront of ``frame`` in a CUDA graph: replayed, it adds the
    batch from the sample id ``first`` to ``outs`` (shaped as the ``outs``
    it was made with), reading the lanes it keeps, and no reference to the
    scene. ``graph`` is None where the capture failed or a scene or camera
    tensor requires grad: that scene runs eagerly."""

    def __init__(self, frame, outs):
        scene = frame.scene
        self.key = frame.key
        self.leaves = leaves((scene, frame.cam))
        self.outs = tuple(torch.zeros_like(o) for o in outs)
        self.first = torch.zeros((), dtype=torch.int32, device=scene.device)
        self.graph = None
        if any(t.requires_grad for t in self.leaves):
            return
        # a replay reads them where the capture found them: keep them
        self.lanes = frame.lanes()

        def wavefront():
            for mine, new in zip(self.outs, frame.step(
                    scene, self.outs, self.lanes, self.first)):
                mine.copy_(new)
        try:
            self.graph = Graph(wavefront, scene.device)
        except RuntimeError as e:
            warnings.warn(f"{frame.name}'s wavefront did not capture in a "
                          f"CUDA graph and runs eagerly: {e}")

    def takes(self, key) -> bool:
        (objs, values), (mine, my_values) = key, self.key
        return len(objs) == len(mine) and \
            all(a is b for a, b in zip(objs, mine)) and values == my_values

    def replays(self) -> bool:
        return self.graph is not None and \
            not any(t.requires_grad for t in self.leaves)


def run(frame, graphs: bool):
    """The wavefronts of one render: from ``frame.accumulators()``,
    ``outs = frame.step(frame.scene, outs, lanes, first)`` for each
    ``first`` of ``frame.firsts`` (an int, or the capture's 0-d device
    tensor), each eager or a replay of the scene's capture where ``graphs``
    holds, the capture takes ``frame.key`` and no span records.
    ``frame.lanes()`` runs once a render, for an eager wavefront, and once
    more for a capture, which keeps its own. After an eager wavefront with
    ``graphs``, no capture of the key and no profiler, a capture replaces
    the scene's. Returns (outs, lanes): a capture's own where every
    wavefront replayed."""
    name, scene, key = frame.name, frame.scene, frame.key
    outs = frame.accumulators()
    made = cap = None
    for first in frame.firsts:
        cap = _CAPTURED.get((id(scene), name)) if graphs else None
        if cap is not None and not cap.takes(key):
            cap = None
        if cap is not None and cap.replays() and \
                not profiling.recording_on():
            if outs is not cap.outs:
                for mine, o in zip(cap.outs, outs):
                    mine.copy_(o)
                outs = cap.outs
            cap.first.fill_(first)
            cap.graph.replay()
            REPLAYED[name] += 1
            continue
        if made is None:
            made = frame.lanes()
        outs = frame.step(scene, outs, made, first)
        EAGER[name] += 1
        if graphs and cap is None and not profiling._profiler_enabled():
            _capture(frame, outs)
    return outs, made if made is not None else cap.lanes


def _capture(frame, outs) -> None:
    """Replace the scene's capture of the frame's integrator (freeing the
    old one's memory first)."""
    k = (id(frame.scene), frame.name)
    if _CAPTURED.pop(k, None) is None:
        weakref.finalize(frame.scene, _CAPTURED.pop, k, None)
    _CAPTURED[k] = Captured(frame, outs)
