"""The path tracer's wavefronts replayed from its CUDA graph over all its
wavefronts in the process, in percent, from the counters of the port's
``utils/cuda_graph.py`` (``REPLAYED`` and ``EAGER``, by integrator) as
they stand after the window: the share of the bounce loop's wavefronts
whose launches the host did not dispatch one by one. None where the port
has no such counters or ran no wavefront of the path tracer."""


def read(state, digest):
    from tuturenderer_tpu_torch.utils import cuda_graph as graphs
    replayed = getattr(graphs, "REPLAYED", {}).get("path")
    eager = getattr(graphs, "EAGER", {}).get("path")
    if replayed is None or eager is None or replayed + eager == 0:
        return None
    return 100.0 * replayed / (replayed + eager)
