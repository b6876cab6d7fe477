"""K5's scans (Euclidean and metric, each descent's last included) a
tour, a call, from the counters K5 adds while the program traces."""
from acobench.spans import scans_per_tour


def read(ctx):
    return scans_per_tour()
