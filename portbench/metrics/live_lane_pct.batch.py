"""The live lanes asked of the nearest-hit query over the lanes it was
launched with, over the traced pass's ``isect.nearest`` spans, in
percent: the useful work of the masked wavefront."""
from portbench import spans


def read(state, digest):
    got = spans.live_lanes(digest)
    if got is None or got[1] == 0:
        return None
    return 100.0 * got[0] / got[1]
