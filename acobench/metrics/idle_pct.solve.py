"""The share of the profiled stretch in which no operation ran on the
device (the profiler's device intervals, merged)."""


def read(ctx):
    prof = ctx.get("profile", {})
    if not prof.get("window_s") or not prof.get("busy_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
