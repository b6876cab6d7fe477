"""The window's wall (host clock, ended by a synchronize) over the training
steps completed in it."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["steps"] if ctx.get("steps") else None
