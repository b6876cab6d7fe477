"""K2's share of its roofline in the profiled stretch: its least time
(the copied work count, acobench/kernels/K2.py) over its device time
(the profiler's kernel sums for its names, acobench/kernels/K2.json)."""


def read(ctx):
    prof = ctx.get("profile", {})
    t = prof.get("kernel_s", {}).get("K2", 0.0)
    if not t or "K2" not in ctx.get("least_ms", {}):
        return None
    return 100.0 * ctx["least_ms"]["K2"] * prof["requests"] / (t * 1e3)
