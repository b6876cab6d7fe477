"""Device time of the program's ``heuristic`` span a training step (CUDA
events: the graph, the train-mode forward and the scatter)."""
from acobench.spans import per_root


def read(ctx):
    return per_root("step", "heuristic", "device_ms")
