"""The 95th percentile (nearest rank) of every request's wall in the
window, from the hand-off to the read-back of its results (host clock)."""
import math


def read(ctx):
    walls = sorted(ctx.get("walls_ms", []))
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1]
