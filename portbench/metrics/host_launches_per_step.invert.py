"""Kernel and graph launches the host issued per unit (pass or step) of
the traced window: the profiler's runtime launch records over the units
traced."""


def read(state, digest):
    return digest.host_launches / digest.units
