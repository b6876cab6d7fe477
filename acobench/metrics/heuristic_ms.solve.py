"""Device time of the program's ``heuristic`` phase per request: CUDA events
around the phase (its ``_ops.timer`` hook), summed over the traced window."""


def read(ctx):
    spans = ctx.get("spans_ms", {})
    if "heuristic" not in spans or not ctx.get("requests"):
        return None
    return spans["heuristic"] / ctx["requests"]
