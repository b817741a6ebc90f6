"""Self host time of the intersection queries (the program's ``isect.*``
spans) a traced pass, in ms: the time the host spends in
``ops/intersect.py``'s queries less the shading and draws they hold."""
from portbench import spans


def read(state, digest):
    return spans.self_ms_per_unit(digest,
                                  lambda n: n.startswith("isect."))
