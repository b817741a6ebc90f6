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
"""
from __future__ import annotations

from typing import Dict, Tuple

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
