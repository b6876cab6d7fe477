"""Host time of the program's ``heuristic`` span a request, beside the device
time of ``heuristic_ms.solve``: the larger paces the layer."""
from acobench.spans import per_root


def read(ctx):
    return per_root("request", "heuristic", "host_ms")
