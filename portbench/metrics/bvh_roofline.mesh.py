"""K5 ``bvh_walk_kernel<0>`` and K6 ``bvh_walk_kernel<1>``'s share of
their roofline over the traced pass of the path tracer on a mesh: their
least time (the bytes of the live rays each launch was asked about, and of
the triangles, over the card's peak bandwidth) over their device time in
the trace. Each launch's live rays are the ``live`` count of its
``isect.nearest`` or ``isect.anyhit`` span; nothing is rendered again."""
from portbench import roofline, spans


def read(state, digest):
    traced = spans.traced(digest)
    if traced is None:
        return None
    queries = {kind: [int(s.counts["live"]) for s in traced
                      if s.name == f"isect.{kind}" and "live" in s.counts]
               for kind in ("nearest", "anyhit")}
    return roofline.roofline_pct(digest, queries, state.info["n_tris"],
                                 "bvh_walk_kernel<0>", "bvh_walk_kernel<1>")
