"""Device time of the program's ``local_search`` phase per request: CUDA events
around the phase (its ``_ops.timer`` hook), summed over the traced window."""


def read(ctx):
    spans = ctx.get("spans_ms", {})
    if "local_search" not in spans or not ctx.get("requests"):
        return None
    return spans["local_search"] / ctx["requests"]
