"""Host time of the program's ``optimizer`` span a training step."""
from acobench.spans import per_root


def read(ctx):
    return per_root("step", "optimizer", "host_ms")
