"""K1 ``woop_nearest_kernel`` and K2 ``woop_anyhit_kernel``'s share of
their roofline over the traced passes: their least time (the bytes of the
live rays each launch was asked about, and of the triangles, over the
card's peak bandwidth) over their device time in the trace."""
from portbench import roofline
from portbench.loops import render


def read(state, digest):
    return roofline.roofline_pct(
        digest, lambda: render.traced_queries(state, digest.units),
        state.info["n_tris"], "woop_nearest_kernel", "woop_anyhit_kernel")
