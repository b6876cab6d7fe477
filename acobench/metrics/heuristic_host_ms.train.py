"""Host time of the program's ``heuristic`` span a training step."""
from acobench.spans import per_root


def read(ctx):
    return per_root("step", "heuristic", "host_ms")
