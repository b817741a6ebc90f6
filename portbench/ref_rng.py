"""A frozen copy of the renderer's counter-based random numbers.

Every random decision of the path tracer is a pure uint32 hash of
``(seed, lane, sample, bounce * 32 + purpose)``, so the reference draws
the very numbers the program draws and the two films can be compared
pixel by pixel. The words live in int64; each add, shift and multiply is
reduced modulo 2**32, and a multiply by a 32-bit constant is split into the
constant's 16-bit halves so no intermediate passes 2**49.

This copy is kept here so that a change to the program's generator shows as
a failed comparison instead of moving the yardstick with it.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9

# draw purposes within one path vertex
LIGHT_PICK = 0
LIGHT_U = 1
LIGHT_V = 2
BSDF_U0 = 3
BSDF_U1 = 4
BSDF_LOTTERY = 5
RR = 6


def _mul32(h, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def _mix(h):
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def hash_u32(*words, device=None):
    h = torch.tensor(GOLDEN, dtype=torch.int64, device=device)
    for w in words:
        w = torch.as_tensor(w, device=device).to(torch.int64) & MASK
        h = _mix(h ^ ((w + GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK))
    return h


def uniform(seed, lane, sample, bounce, purpose):
    """U[0, 1) as float32, one per lane: the top 24 bits of the hash."""
    bits = hash_u32(seed, lane, sample, bounce * 32 + purpose,
                    device=lane.device)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
