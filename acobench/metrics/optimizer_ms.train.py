"""Device time of the program's ``optimizer`` span a training step (CUDA
events: the zero-fill and clip, the rate, AdamW's step and zero_grad)."""
from acobench.spans import per_root


def read(ctx):
    return per_root("step", "optimizer", "device_ms")
