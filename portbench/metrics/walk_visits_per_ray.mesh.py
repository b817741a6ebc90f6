"""BVH node visits per live ray of the traced pass's cluster queries: the
sum of the ``visits`` the walk kernels counted over the sum of the
``live`` lanes of the ``isect.nearest``, ``isect.anyhit`` and
``isect.transmit`` spans that carry visits. A dead lane's walk visits the
root once and counts in the visits, not in the live lanes. None where the
program's spans carry no visits (a program that does not count them, or a
trace off the card)."""
from portbench import spans

QUERIES = ("isect.nearest", "isect.anyhit", "isect.transmit")


def read(state, digest):
    traced = spans.traced(digest)
    if traced is None:
        return None
    walks = [s for s in traced if s.name in QUERIES and
             "visits" in s.counts and "live" in s.counts]
    live = sum(int(s.counts["live"]) for s in walks)
    if live == 0:
        return None
    return sum(int(s.counts["visits"]) for s in walks) / live
