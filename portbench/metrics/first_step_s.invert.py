"""Host seconds of the process's first ``step`` span: the first step of
set-up, which the program records whole."""
from portbench import spans


def read(state, digest):
    prof = spans.recorder()
    first = prof.first_unit("step") if prof is not None else None
    if first is None:
        return None
    return first.duration_ns * 1e-9
