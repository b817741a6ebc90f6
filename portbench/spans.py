"""The program's own spans, for the per-layer metrics that read them.

The port records named host spans at its layer boundaries
(``tuturenderer_tpu_torch/utils/profiling.py``) while a profiler is
active, so ``tracing.capture``'s traced units are recorded there. A
unit is a span that is its own root: a pass's ``render`` or a step's
``step``. ``traced`` takes the last ``digest.units`` of them and every
span they hold, which leaves out set-up and a capture's earlier attempts.
A program without the recorder gives None, and its readers report
nothing.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

UNITS = ("render", "step")


def recorder():
    """The port's profiling module where it records spans, else None."""
    try:
        from tuturenderer_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recorded") else None


def traced(digest) -> Optional[List]:
    """Every span of the last ``digest.units`` units, or None where the
    program recorded fewer."""
    prof = recorder()
    if prof is None:
        return None
    spans = prof.recorded()
    roots = [s for s in spans if s.root == s.sid and s.name in UNITS]
    if not roots or len(roots) < digest.units:
        return None
    keep = {r.sid for r in roots[-digest.units:]}
    return [s for s in spans if s.root in keep]


def self_ns(spans) -> Dict[str, int]:
    """Self time by name, summed: each span's duration less those of the
    spans it holds."""
    inner = collections.Counter()
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.duration_ns
    out = collections.Counter()
    for s in spans:
        out[s.name] += s.duration_ns - inner[s.sid]
    return dict(out)


def self_ms_per_unit(digest, match) -> Optional[float]:
    """Self host time a unit, in ms, of the spans whose name ``match``
    accepts."""
    spans = traced(digest)
    if spans is None:
        return None
    total = sum(ns for name, ns in self_ns(spans).items() if match(name))
    return total * 1e-6 / digest.units


def live_lanes(digest, name: str = "isect.nearest"):
    """(live lanes, lanes launched) summed over the traced units' ``name``
    queries, or None. Reading the live counts waits for the card."""
    spans = traced(digest)
    if spans is None:
        return None
    queries = [s for s in spans if s.name == name and "live" in s.counts]
    if not queries:
        return None
    return (sum(int(s.counts["live"]) for s in queries),
            sum(int(s.counts["lanes"]) for s in queries))


def inside(spans, name: str, ancestor: str) -> List:
    """The spans called ``name`` with an ``ancestor`` span around them."""
    by_sid = {s.sid: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        up = s.parent
        while up is not None and up in by_sid:
            if by_sid[up].name == ancestor:
                out.append(s)
                break
            up = by_sid[up].parent
    return out
