"""Device time of the program's ``construction`` phase per request: CUDA events
around the phase (its ``_ops.timer`` hook), summed over the traced window."""


def read(ctx):
    spans = ctx.get("spans_ms", {})
    if "construction" not in spans or not ctx.get("requests"):
        return None
    return spans["construction"] / ctx["requests"]
