"""The whole training step's share of the chip's peak: the least time of
every kernel a step runs (the copied work counts of K6, K7r and K5,
summed) over the profiled stretch's wall per step."""


def read(ctx):
    prof = ctx.get("profile", {})
    least = ctx.get("least_ms", {})
    if not prof.get("window_s") or not least or not prof.get("busy_s"):
        return None
    return 100.0 * sum(least.values()) * prof["requests"] / (prof["window_s"] * 1e3)
