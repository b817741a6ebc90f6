"""Peaks of the card, and the bytes an intersection query needs.

The bytes are counted from the rays and the scene alone, whatever
implements the query: each live ray's inputs read once and its outputs
written once, and each triangle's three vertices read once a launch. A
lane that its path has left (a dead lane) asks nothing and counts nothing,
so the share does not move when a program drops dead lanes before the
launch. Nothing is counted from the program's tables, trees, node visits
or tests.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12

FLOAT = 4
RAY_IN = 6 * FLOAT                 # origin and direction
NEAREST_OUT = 4 * FLOAT            # t, primitive id, two barycentrics
ANYHIT_IN = RAY_IN + FLOAT         # and the segment's length
ANYHIT_OUT = 1                     # a bool
TRIANGLE = 9 * FLOAT               # three vertices


def nearest_bytes(rays: int, triangles: int) -> int:
    return rays * (RAY_IN + NEAREST_OUT) + triangles * TRIANGLE


def anyhit_bytes(rays: int, triangles: int) -> int:
    return rays * (ANYHIT_IN + ANYHIT_OUT) + triangles * TRIANGLE


def roofline_pct(digest, queries, triangles: int, nearest: str,
                 anyhit: str):
    """The least time of the traced launches of the two kernels (their
    bytes over the peak bandwidth) as a percentage of their device time.
    ``queries`` holds the live rays of each launch, {"nearest": [...],
    "anyhit": [...]}, or is a function that returns them. None where the
    trace is incomplete, holds no such launch, or holds another number of
    launches than ``queries``."""
    if not digest.complete:
        return None
    n_near, t_near = digest.kernels[nearest]
    n_any, t_any = digest.kernels[anyhit]
    if n_near + n_any == 0 or t_near + t_any <= 0:
        return None
    q = queries() if callable(queries) else queries
    if (len(q["nearest"]), len(q["anyhit"])) != (n_near, n_any):
        return None
    least = (sum(nearest_bytes(r, triangles) for r in q["nearest"]) +
             sum(anyhit_bytes(r, triangles) for r in q["anyhit"])
             ) / HBM_BYTES_PER_S
    return 100.0 * least / (t_near + t_any)
