"""Device time of the program's ``heuristic`` span less its ``heuristic.k1``
span (K1's entry call), a request: the distance matrix, the folding and
packing of the weights and the casts around K1."""
from acobench.spans import device_less_child


def read(ctx):
    return device_less_child("request", "heuristic", "heuristic.k1")
