"""Self host time of shading (the program's ``shade.*`` spans: the hit
record, material gathers and textures, light sampling and pdfs, the BSDF
and MIS weights) a traced pass, in ms; the RNG's draws are left out."""
from portbench import spans


def read(state, digest):
    return spans.self_ms_per_unit(digest,
                                  lambda n: n.startswith("shade."))
