"""The valid connections over the connection rays BDPT queues (K * N a
wavefront), over the traced pass's ``bdpt.connect`` spans, in percent:
the useful share of its one shadow query."""
from portbench import spans


def read(state, digest):
    traced = spans.traced(digest)
    if traced is None:
        return None
    conn = [s for s in traced if s.name == "bdpt.connect" and
            "live" in s.counts]
    rays = sum(int(s.counts["rays"]) for s in conn)
    if rays == 0:
        return None
    return 100.0 * sum(int(s.counts["live"]) for s in conn) / rays
