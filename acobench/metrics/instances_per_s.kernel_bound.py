"""``instances_per_s`` in the cells whose kernels pace the window (the
device idle a few percent of it), under a bound of their own: the host-paced
main path's runs spread five times as wide, and its bound would hide a slower
kernel here."""


def read(ctx):
    return ctx["instances"] / ctx["window_s"] if ctx.get("window_s") else None
