"""Host time of the program's ``request.prologue`` span a request: the inputs to
the device, the generator and the net to the device, before the heuristic."""
from acobench.spans import per_root


def read(ctx):
    return per_root("request", "request.prologue", "host_ms")
