"""Process start to the first measured request: imports, the kernel
library (built on a checkout's first run, loaded after), weights, instance
pool and the warm-up of the cell's own shapes (host clock)."""


def read(ctx):
    return ctx["setup_s"]
