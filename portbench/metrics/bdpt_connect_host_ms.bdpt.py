"""Self host time of BDPT's strategies (the program's ``bdpt.connect``
span: the strategy loop, the MIS chains and the queued requests, less the
material calls, the shadow query and the draws inside it) a traced pass,
in ms."""
from portbench import spans


def read(state, digest):
    return spans.self_ms_per_unit(digest, lambda n: n == "bdpt.connect")
