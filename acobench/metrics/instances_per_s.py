"""Instances solved in the window over the window's wall (host clock): each
instance through all its T iterations, its best cost and tour read back."""


def read(ctx):
    return ctx["instances"] / ctx["window_s"] if ctx.get("window_s") else None
