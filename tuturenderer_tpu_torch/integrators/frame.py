"""The schedule of one render, stated once for every caller of it: the
lanes of a wavefront and their order, the samples a wavefront takes, the
sample ids of each batch, the step that adds a wavefront to the
accumulators and the image they make. ``render`` hands its frame
(``path.PathFrame``, ``bdpt.BDPTFrame``) to ``utils/cuda_graph.py::run``;
``grad._RenderDiff`` and ``parallel/sharding.py``'s step (a frame over a
tile of pixels with a sample stride) drive the same frames.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..camera import Camera
from ..ops import intersect
from ..options import RenderOptions


class Lanes(NamedTuple):
    """A wavefront's lanes [sb * m]: pixel id (which keys every draw),
    px, py (clamped onto the film for a tile's padding) and the offset of
    the lane's sample id from its batch's first; ``inv`` [m] (int64)
    inverts the frame's pixel order where the image unpermutes."""
    pix: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    soff: torch.Tensor
    inv: Optional[torch.Tensor]


def samples_a_wavefront(samples_per_launch: int, spp: int) -> int:
    """``samples_per_launch`` (at least 1, at most ``spp``) lowered until it
    divides ``spp``: the samples of a pixel one wavefront takes."""
    sb = max(1, min(samples_per_launch or 1, spp))
    while spp % sb:
        sb -= 1
    return sb


class Frame:
    """One render of ``opts.spp`` samples a pixel from ``sample_base`` on,
    over the whole film in the integrator's ``order()``, or over
    ``pixels`` (int32 ids, padding past the film allowed) with the sample
    ids ``s * stride + offset`` of one rank of a mesh. ``firsts`` are the
    batches' first sample ids; a lane traces ``first + soff``.

    A subclass gives ``name`` (its integrator in ``utils/cuda_graph.py``),
    ``accumulators()`` (new at each call), ``step(scene, outs, lanes,
    first)`` (``outs`` plus one batch, traced in ``scene``, whose material
    parameters may differ from the frame's) and ``image(outs, lanes)``."""

    name: str

    def __init__(self, scene, cam: Camera, opts: RenderOptions, seed,
                 sample_base=0, pixels: Optional[torch.Tensor] = None,
                 stride: int = 1, offset: int = 0):
        self.scene, self.cam, self.opts, self.seed = scene, cam, opts, seed
        self.pixels, self.stride = pixels, stride
        self.m = cam.n_pixels if pixels is None else pixels.shape[0]
        spp = opts.spp // stride
        self.sb = samples_a_wavefront(opts.samples_per_launch, spp)
        self.firsts = [sample_base + offset + b * self.sb * stride
                       for b in range(spp // self.sb)]
        # what a wavefront's launches depend on besides the scene (objects
        # compared by identity, values by ==); the dense form names kernels
        self.key = (cam,), (opts, seed, self.sb, intersect.DENSE_KERNEL)

    def order(self) -> Optional[np.ndarray]:
        """The whole film's pixel ids in lane order; None: row-major."""
        return None

    def lanes(self) -> Lanes:
        dev = self.scene.device
        order = self.order() if self.pixels is None else None
        if self.pixels is not None:
            pix = self.pixels
        elif order is None:
            pix = torch.arange(self.m, dtype=torch.int32, device=dev)
        else:
            pix = torch.from_numpy(order).to(dev)
        inv = None if order is None else \
            torch.from_numpy(np.argsort(order)).to(dev)
        pix = pix.repeat(self.sb)
        soff = torch.arange(0, self.sb * self.stride, self.stride,
                            dtype=torch.int32, device=dev) \
            .repeat_interleave(self.m)
        w, h = self.cam.width, self.cam.height
        return Lanes(pix, pix % w, torch.clamp(pix // w, max=h - 1), soff,
                     inv)
