"""The share of a step's wall time the host spends inside the path-replay
backward pass, the profiler's ``_RenderDiffBackward`` autograd node, in
percent over the traced steps."""


def read(state, digest):
    inside = digest.host_spans.get("_RenderDiffBackward", 0.0)
    if inside <= 0:
        return None
    return 100.0 * inside / sum(digest.unit_seconds)
