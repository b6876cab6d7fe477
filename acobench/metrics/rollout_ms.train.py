"""Device time of a training step's ``rollout`` phase per step: CUDA events
around the phase (its ``_ops.timer`` hook), summed over the traced window."""


def read(ctx):
    spans = ctx.get("spans_ms", {})
    if "rollout" not in spans or not ctx.get("steps"):
        return None
    return spans["rollout"] / ctx["steps"]
