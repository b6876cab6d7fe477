"""K5's share of its roofline in the profiled stretch, at the scans it
counted (``acobench.spans.k5_roofline_pct``: the metric scans priced at no
pair work, a lower bound)."""
from acobench.spans import k5_roofline_pct


def read(ctx):
    return k5_roofline_pct(ctx)
