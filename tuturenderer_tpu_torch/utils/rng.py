"""Counter-based RNG, bit-exact with ``tuturenderer_tpu/utils/rng.py``.

Every random decision is a pure function of ``(seed, lane, sample, bounce,
purpose)``, so this package draws the same numbers as the JAX package for
every lane, which lets the two be compared per lane.

The JAX generator works in uint32. PyTorch has no full uint32 arithmetic,
so the words live in int64 and every add, left shift and multiply is
reduced modulo 2**32 with ``& 0xFFFFFFFF``. A multiply by a 32-bit constant
could pass 2**63, so it is split into the constant's 16-bit halves
(``_mul32``): no intermediate exceeds 2**49.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9

# distinct draw purposes within one path vertex
LIGHT_PICK = 0
LIGHT_U = 1
LIGHT_V = 2
BSDF_U0 = 3
BSDF_U1 = 4
BSDF_LOTTERY = 5
RR = 6
PIXEL_JX = 7
PIXEL_JY = 8
LIGHT_DIR_U0 = 9
LIGHT_DIR_U1 = 10
COMPACT = 11        # compaction-overflow lane roulette


def _mul32(h, c: int):
    """(h * c) mod 2**32 for h in [0, 2**32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def _mix(h):
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def hash_u32(*words):
    """Combine integer words (tensors or ints, broadcastable) into uint32
    values held in an int64 tensor."""
    device = next((w.device for w in words if isinstance(w, torch.Tensor)),
                  None)
    h = torch.tensor(GOLDEN, dtype=torch.int64, device=device)
    for w in words:
        w = torch.as_tensor(w, device=device).to(torch.int64) & MASK
        h = _mix(h ^ ((w + GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK))
    return h


def uniform(seed, lane, sample, bounce, purpose):
    """U[0, 1) float32 for each lane. All args broadcastable ints."""
    bits = hash_u32(seed, lane, sample, bounce * 32 + purpose)
    # 24-bit mantissa -> [0, 1), exact in float32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_simple(seed, lane, tag):
    bits = hash_u32(seed, lane, tag)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
