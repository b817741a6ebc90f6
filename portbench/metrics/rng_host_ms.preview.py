"""Self host time of the counter-based RNG (the program's ``rng`` spans,
``utils/rng.py``'s draws) a traced pass, in ms."""
from portbench import spans


def read(state, digest):
    return spans.self_ms_per_unit(digest, lambda n: n == "rng")
