"""Host seconds of the program's ``tables.build`` span in set-up: the
cluster tables and the BVH of the mesh, built on the host."""


def read(state, digest):
    return state.info.get("tables_build_span_s")
