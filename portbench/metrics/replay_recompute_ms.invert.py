"""Host time a traced step of the bounces the backward pass recomputes:
the program's ``bounce`` spans inside ``replay.grad`` (the checkpoint's
recomputation), their whole durations, in ms."""
from portbench import spans


def read(state, digest):
    traced = spans.traced(digest)
    if traced is None:
        return None
    redo = spans.inside(traced, "bounce", "replay.grad")
    if not redo:
        return None
    return sum(s.duration_ns for s in redo) * 1e-6 / digest.units
